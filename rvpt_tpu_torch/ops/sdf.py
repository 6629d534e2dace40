"""Signed-distance utilities and sphere tracing, the Hart integrator's
engine (mirror of ``rvpt_tpu/ops/sdf.py``; distance_functions.glsl)."""

from __future__ import annotations

import torch

from ..core.math import cross, vdot

MARCH_ITER = 32  # compute_pass.comp:10
MARCH_EPS = 0.1  # compute_pass.comp:11


def _dot2(v):
    return vdot(v, v)


def distance_triangle(p, a, b, c):
    """Unsigned distance from points ``p[...,3]`` to triangles ``a,b,c`` of
    a broadcasting batch shape: Inigo Quilez's formulation, as the
    reference uses it (distance_functions.glsl:28-61)."""
    ba = b - a
    pa = p - a
    cb = c - b
    pb = p - b
    ac = a - c
    pc = p - c
    nor = cross(ba, ac)

    edge_region = (
        torch.sign(vdot(cross(ba, nor), pa))
        + torch.sign(vdot(cross(cb, nor), pb))
        + torch.sign(vdot(cross(ac, nor), pc))
    ) < 2.0

    def edge_dist(e, q):
        h = torch.clamp(vdot(e, q) / torch.clamp(_dot2(e), min=1e-20), 0.0, 1.0)
        return _dot2(e * h[..., None] - q)

    d_edge = torch.minimum(
        torch.minimum(edge_dist(ba, pa), edge_dist(cb, pb)), edge_dist(ac, pc))
    dn = vdot(nor, pa)
    d_face = dn * dn / torch.clamp(_dot2(nor), min=1e-20)
    return torch.sqrt(torch.where(edge_region, d_edge, d_face))


def scene_distance(scene, p, tri_chunk: int = 1024):
    """Min distance from points p[N,3] to all scene triangles -> f32[N],
    +inf without triangles.  Triangles go in blocks of ``tri_chunk`` so the
    temporaries stay [N, tri_chunk]."""
    n = p.shape[0]
    best = torch.full((n,), float("inf"), dtype=torch.float32, device=p.device)
    for base in range(0, scene.num_triangles, tri_chunk):
        sl = slice(base, base + tri_chunk)
        d = distance_triangle(p[:, None, :], scene.tri_v0[None, sl],
                              scene.tri_v1[None, sl], scene.tri_v2[None, sl])
        best = torch.minimum(best, torch.amin(d, dim=1))
    return best


def sphere_trace(scene, origin, direction, mint, maxt):
    """Sphere tracing over the scene's triangle SDF
    (distance_functions.glsl:70-116) -> (t[N], radius[N], iters[N] int32);
    iters == MARCH_ITER where the march never converged (the reference's
    fall-through)."""
    n = origin.shape[0]
    dev = origin.device
    t = torch.full((n,), float(mint), dtype=torch.float32, device=dev)
    p = origin + t[:, None] * direction
    iters = torch.full((n,), MARCH_ITER, dtype=torch.int32, device=dev)
    radius = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    for i in range(MARCH_ITER):
        dist = scene_distance(scene, p)
        stop = (dist < MARCH_EPS) | (dist > maxt)
        newly_done = ~done & stop
        iters = torch.where(newly_done, i, iters)
        radius = torch.where(done, radius, dist)
        advance = ~done & ~stop
        t = torch.where(advance, t + dist, t)
        p = torch.where(advance[:, None], p + dist[:, None] * direction, p)
        done = done | stop
    t = torch.where(done, t, torch.full_like(t, float("inf")))
    return t, radius, iters
