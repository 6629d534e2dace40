"""The eleven integrators over ray batches (mirror of
``rvpt_tpu/models/integrators.py``, integrators.glsl:24-693).

Per-ray early returns become termination masks and the bounce loops a
Python loop over [N] tensors.  A path contributes only when it ends inside
the bounce budget (the reference returns black when the loop runs out,
integrators.glsl:675); ``style='standard'`` also keeps the emission
gathered by unfinished paths.  These are the plain integrator path
(``render_frame(fast=False)``) and the oracles of the kernels.

Integrator ids (= the reference's render-mode indices,
compute_pass.comp:68-99): 0 binary, 1 color, 2 depth, 3 normal, 4 Utah,
5 AO, 6 Appel, 7 Whitted, 8 Cook, 9 Kajiya, 10 Hart.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.math import length, mix, normalize, vdot
from ..core.types import Ray
from ..ops import sdf as sdf_ops
from ..ops.intersect import intersect_scene, occluded
from ..scene.materials import LAMBERT, gather
from . import brdf

WHITE = (1.0, 1.0, 1.0)
BLUE = (0.2, 0.3, 0.7)
# normalize(0.5, 1.0, 0.3) in f32, as the JAX constant.
_LIGHT = torch.tensor([0.5, 1.0, 0.3], dtype=torch.float32)
LIGHT_DIR = _LIGHT / torch.linalg.norm(_LIGHT)
LIGHT_INTENSITY = 1.0
AMBIENT = 0.1
INF = float("inf")

# RNG salt layout: salt = aa_index * AA_STRIDE + bounce * BOUNCE_STRIDE + site.
BOUNCE_STRIDE = 4
AA_STRIDE = 4096

KAJIYA = 9


def _sky(direction, half_shift: bool):
    """Background gradient.  Kajiya shifts d.y into [0,1]
    (integrators.glsl:579); the other integrators use raw d.y (glsl mix
    extrapolates outside [0,1])."""
    y = direction[..., 1]
    t = y * 0.5 + 0.5 if half_shift else y
    white = torch.tensor(WHITE, dtype=torch.float32, device=direction.device)
    blue = torch.tensor(BLUE, dtype=torch.float32, device=direction.device)
    return mix(white[None, :], blue[None, :], t[..., None])


def _light(device):
    return LIGHT_DIR.to(device)[None, :]


def _bounce_rands(pixel, frame, salt_base, bounce):
    salt = salt_base + bounce * BOUNCE_STRIDE
    return rng.uniform3(pixel, frame, salt)


def _zeros3(ray):
    return torch.zeros_like(ray.origin)


# ---------------------------------------------------------------------------
# Single-intersection debug integrators
# ---------------------------------------------------------------------------


def integrator_binary(scene, ray, pixel, frame, settings, salt_base=0):
    """(1,1,1) on any primary hit (integrators.glsl:24-38)."""
    hit = occluded(scene, ray, 0.0, INF)
    return hit[:, None].to(torch.float32).expand(-1, 3)


def integrator_color(scene, ray, pixel, frame, settings, salt_base=0):
    """Base color of the first hit (integrators.glsl:42-59)."""
    isect = intersect_scene(scene, ray, 0.0, INF)
    mat = gather(scene.materials, isect.mat)
    return torch.where(isect.hit[:, None], mat.albedo, _zeros3(ray))


def integrator_depth(scene, ray, pixel, frame, settings, salt_base=0):
    """Reciprocal distance along the ray (integrators.glsl:63-82); misses
    give 1/inf = 0."""
    isect = intersect_scene(scene, ray, 0.0, INF)
    inv_dist = 1.0 / (length(ray.direction) * isect.t)
    return inv_dist[:, None].expand(-1, 3)


def integrator_normal(scene, ray, pixel, frame, settings, salt_base=0):
    """0.5*normal + 0.5 on a hit, black on a miss (integrators.glsl:86-102)."""
    isect = intersect_scene(scene, ray, 0.0, INF)
    return 0.5 * isect.normal + 0.5 * isect.hit[:, None].to(torch.float32)


def integrator_utah(scene, ray, pixel, frame, settings, salt_base=0):
    """Rasterizer-like directional-light shading, no shadows
    (integrators.glsl:106-148)."""
    isect = intersect_scene(scene, ray, 0.0, INF)
    mat = gather(scene.materials, isect.mat)
    sky = _sky(ray.direction, half_shift=False)
    normal = isect.normal
    facing = vdot(ray.direction, normal) < 0.0
    normal = torch.where(facing[:, None], normal, -normal)
    cos_light = torch.clamp(vdot(_light(normal.device), normal), min=0.0)
    col = AMBIENT + mat.emission + mat.albedo * LIGHT_INTENSITY * cos_light[:, None]
    return torch.where(isect.hit[:, None], col, sky)


def integrator_appel(scene, ray, pixel, frame, settings, salt_base=0):
    """Directional light + hard shadow (integrators.glsl:204-250); misses
    return white."""
    isect = intersect_scene(scene, ray, 0.0, INF)
    dir_in = normalize(ray.direction)
    cos_view = vdot(dir_in, isect.normal)
    normal = torch.where((cos_view > 0.0)[:, None], -isect.normal, isect.normal)
    shadow_origin = isect.pos + brdf.EPSILON * normal
    light = _light(normal.device)
    shadow_dir = light.expand_as(normal)
    in_shadow = occluded(scene, Ray(shadow_origin, shadow_dir), 0.0, INF)
    cos_light = torch.clamp(vdot(light, normal), min=0.0)
    lit = LIGHT_INTENSITY * cos_light[:, None] * torch.ones_like(normal)
    col = torch.where(in_shadow[:, None], torch.zeros_like(lit), lit)
    return torch.where(isect.hit[:, None], col, torch.ones_like(col))


def integrator_ao(scene, ray, pixel, frame, settings, salt_base=0):
    """Cosine-weighted ambient occlusion with ``max_bounces`` probe rays
    (integrators.glsl:152-200; the ray count wired from the settings as
    compute_pass.comp:87 does)."""
    nrays = max(int(settings.max_bounces), 1)
    isect = intersect_scene(scene, ray, 0.0, INF)
    facing = vdot(ray.direction, isect.normal) < 0.0
    normal = torch.where(facing[:, None], isect.normal, -isect.normal)
    origin = isect.pos + brdf.EPSILON * normal
    acc = torch.zeros_like(isect.t)
    for i in range(nrays):
        u, v = rng.uniform2(pixel, frame, salt_base + i * BOUNCE_STRIDE)
        d = brdf.scatter_lambert_cos(u, v, normal)
        acc = acc + occluded(scene, Ray(origin, d), 0.0, INF).to(torch.float32)
    ao = 1.0 - acc / nrays
    return torch.where(isect.hit[:, None], ao[:, None].expand(-1, 3),
                       _zeros3(ray))


# ---------------------------------------------------------------------------
# Bounce-loop integrators (Whitted / Cook / Kajiya)
# ---------------------------------------------------------------------------


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


def integrator_whitted(scene, ray, pixel, frame, settings, salt_base=0):
    """Whitted-style: direct Lambert lighting with a hard shadow, stochastic
    reflect/refract for dielectrics (integrators.glsl:254-403).  Starts
    from the ambient term; Lambert hits end the path."""
    n = ray.origin.shape[0]
    dev = ray.origin.device
    o, d = ray.origin, ray.direction
    col = torch.full((n, 3), AMBIENT, dtype=torch.float32, device=dev)
    thr = torch.ones((n, 3), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    result = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    zero3 = torch.zeros_like(col)
    light = _light(dev)
    for bounce in range(int(settings.max_bounces)):
        isect = intersect_scene(scene, Ray(o, d), 0.0, INF)
        hit = isect.hit
        miss_now = active & ~hit
        sky = _sky(d, half_shift=False)
        result = result + torch.where(miss_now[:, None], col + thr * sky, zero3)
        active = active & hit

        mat = gather(scene.materials, isect.mat)
        col = col + torch.where(active[:, None], thr * mat.emission, zero3)

        dir_in = normalize(d)
        normal_f, _, _ = brdf.flip_normal_eta(dir_in, isect.normal, mat.ior)

        # Lambert lanes: direct light + hard shadow, then the path ends.
        is_lam = active & (mat.kind == LAMBERT)
        shadow_origin = isect.pos + brdf.EPSILON * normal_f
        in_shadow = occluded(scene, Ray(shadow_origin, light.expand_as(normal_f)),
                             0.0, INF)
        cos_light = torch.clamp(vdot(light, normal_f), min=0.0)
        direct = col + thr * mat.albedo * LIGHT_INTENSITY * cos_light[:, None]
        lam_out = torch.where(in_shadow[:, None], col, direct)
        result = result + torch.where(is_lam[:, None], lam_out, zero3)
        active = active & ~is_lam

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


def integrator_cook(scene, ray, pixel, frame, settings, salt_base=0):
    """Cook distributed ray tracing: a Lambert hit scatters exactly once
    more, then the path ends on that second hit's emission or the sky
    (integrators.glsl:407-543).  A carried ``final`` mask keeps one scene
    intersection per bounce."""
    nbounce = int(settings.max_bounces)
    n = ray.origin.shape[0]
    dev = ray.origin.device
    o, d = ray.origin, ray.direction
    col = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    thr = torch.ones((n, 3), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    final = torch.zeros((n,), dtype=torch.bool, device=dev)
    result = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    zero3 = torch.zeros_like(col)
    for bounce in range(nbounce):
        isect = intersect_scene(scene, Ray(o, d), 0.0, INF)
        hit = isect.hit
        miss_now = active & ~hit
        sky = _sky(d, half_shift=False)
        result = result + torch.where(miss_now[:, None], col + thr * sky, zero3)
        active = active & hit

        mat = gather(scene.materials, isect.mat)

        # Lanes whose previous bounce scattered off a Lambert surface end on
        # this hit's emission (integrators.glsl:483-487).
        fin_now = active & final
        result = result + torch.where(fin_now[:, None], col + thr * mat.emission,
                                      zero3)
        active = active & ~final

        col = col + torch.where(active[:, None], thr * mat.emission, zero3)

        dir_in = normalize(d)
        u, v, w = _bounce_rands(pixel, frame, salt_base, bounce)
        pos_out, dir_out, fac = brdf.shade_and_scatter(
            isect.pos, isect.normal, dir_in, mat, u, v, w)
        final = active & (mat.kind == LAMBERT)
        a3 = active[:, None]
        thr = torch.where(a3, thr * fac, thr)
        o = torch.where(a3, pos_out, o)
        d = torch.where(a3, dir_out, d)
    # The reference makes the Lambert follow-up intersection inside the same
    # loop iteration, so a Lambert scatter on the last bounce still resolves.
    if nbounce > 0:
        fin = active & final
        isect = intersect_scene(scene, Ray(o, d), 0.0, INF)
        mat = gather(scene.materials, isect.mat)
        sky = _sky(d, half_shift=False)
        tail = torch.where(isect.hit[:, None], col + thr * mat.emission,
                           col + thr * sky)
        result = result + torch.where(fin[:, None], tail, zero3)
        active = active & ~final
    if settings.style == "standard":
        result = result + torch.where(active[:, None], col, zero3)
    return result


def integrator_hart(scene, ray, pixel, frame, settings, salt_base=0):
    """Sphere-tracing iteration heat map (integrators.glsl:681-693)."""
    _, _, iters = sdf_ops.sphere_trace(scene, ray.origin, ray.direction, 0.0, INF)
    val = iters.to(torch.float32) / float(sdf_ops.MARCH_ITER - 1)
    return val[:, None].expand(-1, 3)


INTEGRATORS = {
    0: integrator_binary,
    1: integrator_color,
    2: integrator_depth,
    3: integrator_normal,
    4: integrator_utah,
    5: integrator_ao,
    6: integrator_appel,
    7: integrator_whitted,
    8: integrator_cook,
    9: integrator_kajiya,
    10: integrator_hart,
}

INTEGRATOR_NAMES = {
    "binary": 0,
    "color": 1,
    "depth": 2,
    "normal": 3,
    "utah": 4,
    "ao": 5,
    "appel": 6,
    "whitted": 7,
    "cook": 8,
    "kajiya": 9,
    "hart": 10,
}


def eval_integrator(mode: int, scene, ray, pixel, frame, settings, salt_base=0):
    """Dispatch by integrator id (compute_pass.comp:68-99); ids outside the
    table fall back to Hart, like the reference's ``default`` case."""
    fn = INTEGRATORS.get(int(mode), integrator_hart)
    return fn(scene, ray, pixel, frame, settings, salt_base)
