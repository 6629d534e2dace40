"""Brute-force ray/primitive intersection over ray batches (mirror of
``rvpt_tpu/ops/intersect.py``, its brute-force half).

Every test is phrased over a ``[rays, prims]`` block built from component
broadcasts, with the metric-tensor triangle test of the reference
(intersection.glsl:267-323).  Ties keep the first minimum: the lowest
index within a family, and the earlier family (triangles, then spheres,
then planes) across families.  On the card the triangle search runs the
CUDA kernel of ``intersect_pk``; on the CPU a BVH scene walks its tree
(``ops.traverse``), as the JAX package does there.
"""

from __future__ import annotations

import torch

from ..core.math import cross, normalize, vdot
from ..core.types import Isect, Ray
from ..scene.scene import Scene

INF = float("inf")

# Primitive family codes used in hit records.
FAM_NONE = -1
FAM_TRI = 0
FAM_SPH = 1
FAM_PLN = 2

_DENOM_EPS = 1e-30
_NO_INDEX = 2**30


def _pdot(a, b):
    """Pairwise dot of [N,3] rays against [T,3] primitive vectors -> [N,T],
    as component broadcasts (the rounding of the JAX path)."""
    return (a[:, 0:1] * b[None, :, 0] + a[:, 1:2] * b[None, :, 1]
            + a[:, 2:3] * b[None, :, 2])


def _min_and_first_index(t, dim):
    """(min t, index of the first min) along ``dim``."""
    tb = torch.amin(t, dim=dim)
    shape = [1] * t.dim()
    shape[dim] = t.shape[dim]
    iota = torch.arange(t.shape[dim], device=t.device).reshape(shape)
    first = torch.amin(
        torch.where(t == tb.unsqueeze(dim), iota, _NO_INDEX), dim=dim)
    return tb, first


def _safe_div(num, den):
    """num/den with a sign-preserving clamp: 0-denominators give huge t
    (rejected by range tests) instead of NaNs."""
    den_safe = torch.where(torch.abs(den) < _DENOM_EPS,
                           torch.full_like(den, _DENOM_EPS), den)
    return num / den_safe


def _miss(n, device):
    return (torch.full((n,), INF, device=device),
            torch.full((n,), -1, dtype=torch.int64, device=device))


# ---------------------------------------------------------------------------
# Triangles
# ---------------------------------------------------------------------------


def triangle_precompute(v0, v1, v2):
    """Per-triangle quantities reused by every ray: edges, geometric normal
    and the adjoint of the 2x2 Gram matrix (intersection.glsl:267-323)."""
    e0 = v1 - v0
    e1 = v2 - v0
    n = cross(e0, e1)
    g00 = vdot(e0, e0)
    g11 = vdot(e1, e1)
    g01 = vdot(e0, e1)
    inv_det = _safe_div(torch.ones_like(g00), g00 * g11 - g01 * g01)
    return dict(
        e0=e0, e1=e1, n=n,
        v0n=vdot(v0, n), v0e0=vdot(v0, e0), v0e1=vdot(v0, e1),
        g00=g00, g11=g11, g01=g01, inv_det=inv_det,
    )


def _tri_block_best(o, d, pre, mint, maxt):
    """Closest valid hit per ray within one triangle block: (t[N], col[N])."""
    dn = _pdot(d, pre["n"])
    on = _pdot(o, pre["n"])
    de0 = _pdot(d, pre["e0"])
    de1 = _pdot(d, pre["e1"])
    oe0 = _pdot(o, pre["e0"])
    oe1 = _pdot(o, pre["e1"])
    t = _safe_div(pre["v0n"][None, :] - on, dn)
    b0 = oe0 + t * de0 - pre["v0e0"][None, :]
    b1 = oe1 + t * de1 - pre["v0e1"][None, :]
    u = pre["inv_det"][None, :] * (pre["g11"][None, :] * b0 - pre["g01"][None, :] * b1)
    v = pre["inv_det"][None, :] * (pre["g00"][None, :] * b1 - pre["g01"][None, :] * b0)
    valid = (mint < t) & (t < maxt) & (u > 0.0) & (v > 0.0) & (u + v < 1.0)
    t = torch.where(valid, t, torch.full_like(t, INF))
    return _min_and_first_index(t, dim=1)


def closest_hit_triangles(origin, direction, v0, v1, v2, mint, maxt,
                          tri_chunk: int = 2048):
    """Brute-force closest hit of N rays against T triangles:
    (t[N], inf on a miss; idx[N], -1 on a miss).  Triangle blocks of
    ``tri_chunk`` keep the temporaries at [N, tri_chunk]."""
    n = origin.shape[0]
    t_run, i_run = _miss(n, origin.device)
    for base in range(0, v0.shape[0], tri_chunk):
        sl = slice(base, base + tri_chunk)
        pre = triangle_precompute(v0[sl], v1[sl], v2[sl])
        t_c, col = _tri_block_best(origin, direction, pre, mint, maxt)
        better = t_c < t_run
        t_run = torch.where(better, t_c, t_run)
        i_run = torch.where(better, base + col, i_run)
    return t_run, i_run


def any_hit_triangles(origin, direction, v0, v1, v2, mint, maxt,
                      tri_chunk: int = 2048):
    """Boolean occlusion test (shadow rays): any valid hit in (mint, maxt)."""
    _, idx = closest_hit_triangles(origin, direction, v0, v1, v2, mint, maxt,
                                   tri_chunk)
    return idx >= 0


def triangle_isect_single(o, d, v0, v1, v2):
    """t, u, v, normal for matched ray/triangle batches [N] (rebuilds the
    record of the winning triangle)."""
    e0 = v1 - v0
    e1 = v2 - v0
    n = cross(e0, e1)
    t = _safe_div(vdot(v0 - o, n), vdot(d, n))
    p0 = o + t[..., None] * d - v0
    b0 = vdot(p0, e0)
    b1 = vdot(p0, e1)
    g00 = vdot(e0, e0)
    g11 = vdot(e1, e1)
    g01 = vdot(e0, e1)
    inv_det = _safe_div(torch.ones_like(g00), g00 * g11 - g01 * g01)
    u = inv_det * (g11 * b0 - g01 * b1)
    v = inv_det * (g00 * b1 - g01 * b0)
    return t, u, v, n


# ---------------------------------------------------------------------------
# Spheres and planes
# ---------------------------------------------------------------------------


def closest_hit_spheres(origin, direction, center, radius, mint, maxt):
    """Closest hit of N rays against S spheres: (t[N], idx[N]).  Nearest
    root inside (mint, maxt), else the far root (ray inside the sphere)."""
    if center.shape[0] == 0:
        return _miss(origin.shape[0], origin.device)
    cx, cy, cz = center[:, 0:1], center[:, 1:2], center[:, 2:3]  # [S,1]
    ox, oy, oz = origin[:, 0], origin[:, 1], origin[:, 2]  # [N]
    dx, dy, dz = direction[:, 0], direction[:, 1], direction[:, 2]
    ocx = ox[None, :] - cx
    ocy = oy[None, :] - cy
    ocz = oz[None, :] - cz  # [S,N]
    dd = (dx * dx + dy * dy + dz * dz)[None, :]
    b_half = dx[None, :] * ocx + dy[None, :] * ocy + dz[None, :] * ocz
    c_term = ocx * ocx + ocy * ocy + ocz * ocz - (radius * radius)[:, None]
    disc = b_half * b_half - dd * c_term
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = _safe_div(-b_half - sq, dd)
    t1 = _safe_div(-b_half + sq, dd)
    inf = torch.full_like(t0, INF)
    t_near = torch.where((t0 > mint) & (t0 < maxt), t0, inf)
    t_far = torch.where((t1 > mint) & (t1 < maxt), t1, inf)
    t = torch.where(disc > 0.0, torch.minimum(t_near, t_far), inf)
    tbest, row = _min_and_first_index(t, dim=0)
    return tbest, torch.where(torch.isfinite(tbest), row, -1)


def sphere_isect_single(o, d, center, radius, mint):
    """t for matched ray/sphere batches [N]: the near root if past ``mint``,
    else the far root (the search phase's rule)."""
    oc = o - center
    dd = vdot(d, d)
    b_half = vdot(d, oc)
    c_term = vdot(oc, oc) - radius * radius
    disc = torch.clamp(b_half * b_half - dd * c_term, min=1e-12)
    sq = torch.sqrt(disc)
    t0 = _safe_div(-b_half - sq, dd)
    t1 = _safe_div(-b_half + sq, dd)
    return torch.where(t0 > mint, t0, t1)


def closest_hit_planes(origin, direction, normal, d_off, mint, maxt):
    """Closest hit of N rays against P planes <p,n> = d
    (intersection.glsl:100-129): (t[N], idx[N])."""
    if normal.shape[0] == 0:
        return _miss(origin.shape[0], origin.device)
    nx, ny, nz = normal[:, 0:1], normal[:, 1:2], normal[:, 2:3]  # [P,1]
    on = nx * origin[None, :, 0] + ny * origin[None, :, 1] + nz * origin[None, :, 2]
    dn = (nx * direction[None, :, 0] + ny * direction[None, :, 1]
          + nz * direction[None, :, 2])
    t = _safe_div(d_off[:, None] - on, dn)
    t = torch.where((t > mint) & (t < maxt), t, torch.full_like(t, INF))
    tbest, row = _min_and_first_index(t, dim=0)
    return tbest, torch.where(torch.isfinite(tbest), row, -1)


def plane_isect_single(o, d, normal, d_off):
    return _safe_div(d_off - vdot(o, normal), vdot(d, normal))


# ---------------------------------------------------------------------------
# AABB slab test (the BVH walk's building block)
# ---------------------------------------------------------------------------


def intersect_aabb(origin, direction, box_min, box_max, mint, maxt):
    """Slab test in f32 (intersection.glsl:349-350 used f64 temporaries by
    accident): bool, True where the ray meets the box inside [mint, maxt].
    Broadcasts over matching batch shapes [..., 3]."""
    inv_d = _safe_div(torch.ones_like(direction), direction)
    f = (box_max - origin) * inv_d
    n = (box_min - origin) * inv_d
    t1 = torch.amin(torch.maximum(f, n), dim=-1)
    t0 = torch.amax(torch.minimum(f, n), dim=-1)
    return torch.clamp(t1, max=maxt) >= torch.clamp(t0, min=mint)


# ---------------------------------------------------------------------------
# Whole scene
# ---------------------------------------------------------------------------


def closest_hit_scene(scene: Scene, ray: Ray, mint, maxt, tri_chunk: int = 2048):
    """Closest hit across all primitive families: (family[N], idx[N], t[N]),
    family and index -1 on a miss.

    Rays on the card search the triangles with the CUDA kernel B8
    (``intersect_pk.launch_closest_hit``), on detached inputs: the search
    selects and does not differentiate, and ``isect_from_hit`` rebuilds the
    differentiable record from the index.  Rays on the CPU walk the BVH of
    a BVH scene (``traverse.closest_hit_bvh``, ``intersect.py:389-396`` of
    the JAX package) and take the plain search ``closest_hit_triangles``
    otherwise."""
    o, d = ray.origin, ray.direction
    if scene.num_triangles > 0 and o.device.type == "cpu" and scene.bvh is not None:
        from . import traverse

        with torch.no_grad():
            t_tri, i_tri = traverse.closest_hit_bvh(scene, scene.bvh, o, d, mint,
                                                    maxt)
    elif scene.num_triangles > 0 and o.device.type == "cuda":
        from . import intersect_pk

        packed = intersect_pk.pack_triangles(
            scene.tri_v0.detach(), scene.tri_v1.detach(), scene.tri_v2.detach())
        t_tri, i_tri = intersect_pk.launch_closest_hit(
            o.detach().contiguous(), d.detach().contiguous(), packed, mint, maxt)
    else:
        t_tri, i_tri = closest_hit_triangles(
            o, d, scene.tri_v0, scene.tri_v1, scene.tri_v2, mint, maxt, tri_chunk)
    t_sph, i_sph = closest_hit_spheres(o, d, scene.sph_center, scene.sph_radius,
                                       mint, maxt)
    t_pln, i_pln = closest_hit_planes(o, d, scene.pln_normal, scene.pln_d,
                                      mint, maxt)

    t = t_tri
    fam = torch.where(torch.isfinite(t_tri), FAM_TRI, FAM_NONE)
    idx = i_tri
    better = t_sph < t
    t = torch.where(better, t_sph, t)
    fam = torch.where(better, FAM_SPH, fam)
    idx = torch.where(better, i_sph, idx)
    better = t_pln < t
    t = torch.where(better, t_pln, t)
    fam = torch.where(better, FAM_PLN, fam)
    idx = torch.where(better, i_pln, idx)
    return fam, idx, t


def isect_from_hit(scene: Scene, ray: Ray, fam, idx, mint=1e-2) -> Isect:
    """Intersection record for an already-selected primitive, rebuilt from
    the gathered primitive data (intersection.glsl:489-517 conventions:
    t=inf, zero pos/normal on a miss; the normal is normalized)."""
    o, d = ray.origin, ray.direction
    n_rays = o.shape[0]
    dev = o.device
    zero3 = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)

    t = torch.full((n_rays,), INF, device=dev)
    normal = zero3
    uv = torch.zeros((n_rays, 2), dtype=torch.float32, device=dev)
    mat = torch.full((n_rays,), -1, dtype=torch.int64, device=dev)

    if scene.num_triangles > 0:
        safe = torch.clamp(idx, 0, scene.num_triangles - 1)
        t_t, u_t, v_t, n_t = triangle_isect_single(
            o, d, scene.tri_v0[safe], scene.tri_v1[safe], scene.tri_v2[safe])
        m = fam == FAM_TRI
        t = torch.where(m, t_t, t)
        normal = torch.where(m[:, None], n_t, normal)
        uv = torch.where(m[:, None], torch.stack([u_t, v_t], dim=-1), uv)
        mat = torch.where(m, scene.tri_mat[safe], mat)

    if scene.num_spheres > 0:
        safe = torch.clamp(idx, 0, scene.num_spheres - 1)
        c = scene.sph_center[safe]
        t_s = sphere_isect_single(o, d, c, scene.sph_radius[safe], mint)
        m = fam == FAM_SPH
        t_s_safe = torch.where(m, torch.clamp(t_s, -1e6, 1e6),
                               torch.zeros_like(t_s))
        pos_s = o + t_s_safe[:, None] * d
        t = torch.where(m, t_s, t)
        normal = torch.where(m[:, None], pos_s - c, normal)
        mat = torch.where(m, scene.sph_mat[safe], mat)

    if scene.num_planes > 0:
        safe = torch.clamp(idx, 0, scene.num_planes - 1)
        pn = scene.pln_normal[safe]
        t_p = plane_isect_single(o, d, pn, scene.pln_d[safe])
        m = fam == FAM_PLN
        t = torch.where(m, t_p, t)
        normal = torch.where(m[:, None], pn, normal)
        mat = torch.where(m, scene.pln_mat[safe], mat)

    hit = torch.isfinite(t)
    t_for_pos = torch.where(hit, torch.clamp(t, -1e6, 1e6), torch.zeros_like(t))
    pos = torch.where(hit[:, None], o + t_for_pos[:, None] * d, zero3)
    normal = torch.where(hit[:, None], normalize(normal), zero3)
    return Isect(t=t, pos=pos, normal=normal, uv=uv, prim=idx, mat=mat)


def intersect_scene(scene: Scene, ray: Ray, mint, maxt, tri_chunk: int = 2048) -> Isect:
    """Search + record rebuild, the one-call scene intersector."""
    fam, idx, _ = closest_hit_scene(scene, ray, mint, maxt, tri_chunk)
    return isect_from_hit(scene, ray, fam, idx, mint)


def occluded(scene: Scene, ray: Ray, mint, maxt, tri_chunk: int = 2048) -> torch.Tensor:
    """Boolean shadow query across every family (intersect_scene_any,
    intersection.glsl:467-485); rays on the card launch B8."""
    fam, _, _ = closest_hit_scene(scene, ray, mint, maxt, tri_chunk)
    return fam != FAM_NONE
