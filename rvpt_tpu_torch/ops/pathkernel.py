"""Whole-path tracer, primary-hit and Hart kernels, the big-mesh kernels
and the whole-chain pullback: the ports of the Pallas kernels K1, B3, B4,
B5, B6 and K2.

``rvpt_tpu/ops/pathkernel.py`` traces whole paths in one Pallas launch per
group of <= 8 bounces (make_path_kernel :1115, _path_call :1276) with the
Kajiya, Whitted or Cook bounce integrator, optionally writing per-bounce
records; runs the single-intersection debug integrators (modes 0-6) in one
launch (make_primary_kernel :3390, _primary_call :3445); sphere-traces the
triangle SDF for the Hart heat map (make_hart_kernel :3564, _hart_call
:3632); traces BVH meshes of more than 1,024 triangles one bounce or one
search per launch (make_bigmesh_dma_kernel :2366 and make_bigmesh_kernel
:2061, BigMeshTracer :2927) with their Hart distance per march step
(make_bigmesh_hart_kernel :2820; here the whole march is one launch); and
pulls an image cotangent back through the whole chain from the records
(make_bwd_kernel :1346, _bwd_call :1609, bwd_path :1801).  Here each
function has two versions:

* ``csrc/path_kernel.cu`` (K1), ``csrc/primary_kernel.cu`` (B3),
  ``csrc/hart_kernel.cu`` (B4), ``csrc/bigmesh_kernel.cu`` (B5),
  ``csrc/bigmesh_hart.cu`` (B6) and ``csrc/bwd_kernel.cu`` (K2):
  hand-written CUDA for Hopper, one thread per ray, pixel or point
  (``launch_path_kernel``, ``launch_primary_kernel``,
  ``launch_hart_kernel``, ``launch_bigmesh_kernel``,
  ``launch_bigmesh_hart``, ``launch_bigmesh_march``,
  ``launch_bwd_kernel``);
* ``trace_plain``, ``primary_plain``, ``hart_plain``,
  ``bigmesh_bounce_plain``, ``bigmesh_search_plain``,
  ``bigmesh_distance_plain``, ``bigmesh_march_plain`` and ``bwd_plain``:
  the same functions in plain PyTorch on flat [N] tensors, the references
  the kernels are held against.

``PathTracer``, ``BigMeshTracer`` and ``bwd_path`` dispatch on the device
of their tables: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises.  Scene tables are packed in the row form
(one f32 row per primitive) in the field orders below; K1's and B3's row
forms stage them whole in shared memory, each triangle row as four
aligned float4 in ``pack_walk``'s order, test a triangle's t before the
rest of its row, and stop an occlusion search at its first hit
(``_any_hit_plain``); a BVH scene's
triangles are in the tree's leaf order, and K1 and B3 on it (their BVH
form, the port of the culled form) and B5 search them by a per-ray walk of
the ``pack_bvh`` nodes, after the spheres and planes (K1 and B3 read the
triangles as ``pack_walk``'s aligned rows, and stop an occlusion search at
its first hit; B5 keeps the binary walk, the reference).  ``BigMeshTracer``
runs a big mesh through K1's and B3's BVH forms with its rays passed in,
one launch per frame; B5's per-bounce instances stay as its ``bounce`` and
``search`` entries.  A trace's record (``PathRecord``, from K1 in either
form) is flat and SoA: per bounce the 13 bounce-input fields and the
(family, index) hit record, -1 where the lane was dead or missed; K1's
hits-only collect instance writes the hit records alone, and B5's collect
instance the same hit record per bounce launch.  A BVH scene's triangle
indices are leaf-order ids, the rows of its own tables.
"""

from __future__ import annotations

import contextvars
import ctypes
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..core import rng
from ..scene.scene import Scene
from .build import check_cuda, check_launch, load_library
from .intersect import _min_and_first_index, triangle_precompute

_BIG = 3.0e38
_DENOM_EPS = 1e-30
_TWO_PI = 6.283185307179586
_EPSILON = 5e-3  # surface offset (compute_pass.comp:9)
_WHITE = (1.0, 1.0, 1.0)
_BLUE = (0.2, 0.3, 0.7)  # sky gradient (integrators.glsl:570-571)
_SKY = tuple(b - w for b, w in zip(_BLUE, _WHITE))  # in double, as the JAX kernel
# Directional light of the debug integrators and Whitted, normalize(0.5,
# 1.0, 0.3) in double as the JAX kernel's constants (pathkernel.py:3283).
_LNORM = (0.5 * 0.5 + 1.0 * 1.0 + 0.3 * 0.3) ** 0.5
_LDIR = (0.5 / _LNORM, 1.0 / _LNORM, 0.3 / _LNORM)
_AMBIENT = 0.1
_LIGHT_I = 1.0

# Bounce integrators of the whole-path kernel, by their C++ template ids.
INTEGS = {"kajiya": 0, "whitted": 1, "cook": 2}
# The single-intersection debug modes of the primary-hit kernel (ids as
# models.integrators.INTEGRATOR_NAMES).
PRIMARY_MODES = frozenset((0, 1, 2, 3, 4, 5, 6))
MARCH_ITER = 32  # compute_pass.comp:10
MARCH_EPS = 0.1  # compute_pass.comp:11

TRI_FIELDS = (
    "nx", "ny", "nz", "e0x", "e0y", "e0z", "e1x", "e1y", "e1z",
    "v0n", "v0e0", "v0e1", "g00", "g11", "g01", "inv_det", "mat",
)
SPH_FIELDS = ("cx", "cy", "cz", "rad", "mat")
PLN_FIELDS = ("nx", "ny", "nz", "doff", "mat")
MAT_FIELDS = ("ar", "ag", "ab", "er", "eg", "eb", "ior", "kind")
# Raw vertex rows of the Hart march (pack_hart).
HART_FIELDS = ("v0x", "v0y", "v0z", "v1x", "v1y", "v1z", "v2x", "v2y", "v2z")

# Raw (vertex-level) differentiable tables of the backward, and its id
# tables (pathkernel.py:75-81).
DIFF_FIELDS = (
    "tv0x", "tv0y", "tv0z", "tv1x", "tv1y", "tv1z", "tv2x", "tv2y", "tv2z",
    "scx", "scy", "scz", "srad",
    "pnx", "pny", "pnz", "pd",
    "mar", "mag", "mab", "mer", "meg", "meb", "mior",
)
NONDIFF_FIELDS = ("tmat", "smat", "pmat", "mkind")
# pack_bwd row widths: each family's DIFF_FIELDS columns, then its id.
BWD_WIDTHS = (10, 5, 5, 8)
GRAD_WIDTHS = (9, 4, 4, 7)
# The kernel backward's bound (the "pallas" route's, fast_grad.py:108):
# K2 stages the raw tables and their gradient sums in shared memory.
MAX_BWD_TRIANGLES = 1024
# BVH routing (pathkernel.py:1906-1913): a BVH scene with more than
# min(BIG_ROUTE_TRIS, CULL_MAX_TRIS) triangles is a big mesh and runs on
# BigMeshTracer (B5, B6); one with fewer runs K1's and B3's BVH form.
BIG_ROUTE_TRIS = 1024
CULL_MAX_TRIS = 8192
# The culled form's clusters (``pack_cull`` :118): CULL_K leaf-ordered
# triangles to a cluster, CULL_G clusters to a supergroup; its stats count
# per tile of CULL_TILE consecutive rays of the flat order (CULL_S x
# CULL_L, ``_to_ctiles`` :2291).
CULL_K = 16
CULL_G = 64
CULL_TILE = 8 * 1024
# The per-thread stack of the kernels' BVH walks (csrc/bvh_search.cuh,
# csrc/bvh_walk.cuh): the deepest node's depth must stay below it.
BVH_STACK = 64
# One triangle row of K1's and B3's walk (pack_walk), four float4: the
# normal and v0.n, e0 and v0.e0, e1 and v0.e1, the metric tensor's terms.
WALK_FIELDS = ("nx", "ny", "nz", "v0n", "e0x", "e0y", "e0z", "v0e0",
               "e1x", "e1y", "e1z", "v0e1", "g00", "g11", "g01", "inv_det")
# One node of pack_bvh: padded box lo xyz, hi xyz, then first and count as
# int32 bit patterns.
NODE_FIELDS = ("lox", "loy", "loz", "hix", "hiy", "hiz", "first", "count")
# The big-mesh bounce kernel's ray state, f32[16, N]: the 15 carries, then
# active as 0/1 (BigMeshTracer.trace).
STATE_FIELDS = ("ox", "oy", "oz", "dx", "dy", "dz", "tr", "tg", "tb",
                "cr", "cg", "cb", "rr", "rg", "rb", "active")

# Record fields per bounce: o, d, throughput, gathered color, active.
RECORD_FIELDS = ("ox", "oy", "oz", "dx", "dy", "dz", "tr", "tg", "tb",
                 "cr", "cg", "cb", "active")


class PathRecord(NamedTuple):
    """Per-bounce record of a trace, flat and SoA over N rays:
    ``fields`` f32[B, 13, N] (``RECORD_FIELDS`` at each bounce's start,
    ``active`` as 0/1) and ``hits`` int32[B, 2, N] (family, index of the
    hit, -1 where the lane was dead or missed)."""

    fields: torch.Tensor
    hits: torch.Tensor

# Camera parameter vector layout (f32[24]).
CAM_M = 0          # 0..15: camera matrix, row-major
CAM_ASPECT = 16
CAM_PROJ = 17      # pinhole/spherical: 1/tan(hfov/2); ortho: scale
CAM_INV_W = 18
CAM_INV_H = 19
CAM_W = 20
PINHOLE, ORTHO, SPHERICAL = 0, 1, 2


def pack_fwd(scene: Scene) -> tuple[torch.Tensor, tuple[int, int, int, int]]:
    """Search and shading tables in the row form: one flat f32 buffer of
    [T,17] triangle rows (precomputed metric-tensor form), [S,5] sphere,
    [P,5] plane and [M,8] material rows, plus the counts (T, S, P, M).
    A material-less scene gets one zero row with ior 1."""
    dev = scene.device
    f32 = torch.float32
    t, s, p = scene.num_triangles, scene.num_spheres, scene.num_planes
    pre = triangle_precompute(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    tri = torch.cat([
        pre["n"], pre["e0"], pre["e1"],
        torch.stack([pre["v0n"], pre["v0e0"], pre["v0e1"], pre["g00"],
                     pre["g11"], pre["g01"], pre["inv_det"],
                     scene.tri_mat.to(f32)], dim=-1),
    ], dim=-1).reshape(t, 17)
    sph = torch.cat([scene.sph_center, scene.sph_radius[:, None],
                     scene.sph_mat.to(f32)[:, None]], dim=-1).reshape(s, 5)
    pln = torch.cat([scene.pln_normal, scene.pln_d[:, None],
                     scene.pln_mat.to(f32)[:, None]], dim=-1).reshape(p, 5)
    m = scene.materials
    if m.count:
        mat = torch.cat([m.albedo, m.emission, m.ior[:, None],
                         m.kind.to(f32)[:, None]], dim=-1)
    else:
        mat = torch.tensor([[0, 0, 0, 0, 0, 0, 1, 0]], dtype=f32, device=dev)
    flat = torch.cat([tri.reshape(-1), sph.reshape(-1), pln.reshape(-1),
                      mat.reshape(-1)]).to(f32).contiguous()
    return flat, (t, s, p, mat.shape[0])


def stages_tables(scene: Scene) -> bool:
    """Whether the search kernels (K1, B3, B5) can stage ``pack_fwd``'s
    tables of ``scene`` in shared memory: always for a scene on the CPU,
    whose plain versions have no such limit; on the card, up to the
    kernels' opt-in limit there (about 3,400 triangles in Hopper's 227 KB).
    A BVH scene's triangles stay in device memory and are not staged."""
    if scene.device.type != "cuda" or PLAIN_KERNELS.get():
        return True
    staged_tris = 0 if scene.bvh is not None else scene.num_triangles
    floats = (len(TRI_FIELDS) * staged_tris
              + len(SPH_FIELDS) * scene.num_spheres
              + len(PLN_FIELDS) * scene.num_planes
              + len(MAT_FIELDS) * max(scene.materials.count, 1))
    return floats <= _path_lib().rvpt_max_table_floats()


def pack_hart(scene: Scene) -> tuple[torch.Tensor, int]:
    """Raw vertex rows of the Hart march (``pack_hart`` :3498): one flat
    f32 buffer of [T,9] rows (``HART_FIELDS``) and the count T.  No
    padding: the kernel stages any count, zero included."""
    t = scene.num_triangles
    rows = torch.cat([scene.tri_v0, scene.tri_v1, scene.tri_v2], dim=-1)
    return rows.reshape(t * 9).to(torch.float32).contiguous(), t


def is_bigmesh(scene: Scene) -> bool:
    """True when a scene routes through ``BigMeshTracer`` (``is_bigmesh``
    :1909): it has a BVH and more than min(BIG_ROUTE_TRIS, CULL_MAX_TRIS)
    triangles."""
    return (scene.bvh is not None
            and scene.num_triangles > min(BIG_ROUTE_TRIS, CULL_MAX_TRIS))


def bvh_eps(scene: Scene) -> torch.Tensor:
    """The box padding of ``pack_cull`` (:148): 1e-4 of the triangles'
    extent plus 1e-6, in f32.  Without it a flat box (the quad light at
    y = 2.4) can be pruned by rounding."""
    bmin = torch.minimum(torch.minimum(scene.tri_v0, scene.tri_v1), scene.tri_v2)
    bmax = torch.maximum(torch.maximum(scene.tri_v0, scene.tri_v1), scene.tri_v2)
    return 1e-4 * torch.max(bmax) - 1e-4 * torch.min(bmin) + 1e-6


def pack_bvh(scene: Scene) -> torch.Tensor:
    """The BVH's nodes for the kernels' walk: f32[M, 8] rows
    (``NODE_FIELDS``), each box padded by ``bvh_eps``, first and count as
    int32 bit patterns.  Raises when the tree is deeper than the walk's
    stack (``BVH_STACK``)."""
    bvh = scene.bvh
    if bvh is None or scene.num_triangles == 0:
        raise ValueError("pack_bvh needs a BVH scene with triangles")
    if bvh.depth >= BVH_STACK:
        raise ValueError(f"BVH depth {bvh.depth} does not fit the walk's "
                         f"{BVH_STACK}-entry stack")
    eps = bvh_eps(scene)
    ints = torch.stack([bvh.first, bvh.count], dim=1).to(torch.int32)
    return torch.cat([bvh.bmin - eps, bvh.bmax + eps,
                      ints.view(torch.float32)], dim=1).contiguous()


def pack_walk(tables: torch.Tensor, counts) -> torch.Tensor:
    """The triangle rows of K1's and B3's BVH walk (csrc/bvh_walk.cuh) from
    ``pack_fwd``'s: one flat f32 buffer of [T,16] rows (``WALK_FIELDS``,
    four aligned float4 each), then the material ids f32[T], both in the
    tree's leaf order.  A rearrangement of the [T,17] rows: no value is
    computed anew."""
    t = counts[0]
    rows = tables[:len(TRI_FIELDS) * t].reshape(t, len(TRI_FIELDS))
    cols = [TRI_FIELDS.index(f) for f in WALK_FIELDS]
    return torch.cat([rows[:, cols].reshape(-1),
                      rows[:, TRI_FIELDS.index("mat")]]).contiguous()


class WalkTree(NamedTuple):
    """What K1's and B3's BVH form walk (csrc/bvh_walk.cuh), built together
    by ``pack_tree``: ``pack_bvh``'s nodes and ``pack_walk``'s triangle
    rows.  B5, B6 and ``count_bvh_walk`` take the nodes alone."""

    nodes: torch.Tensor  # f32[M, 8]
    rows: torch.Tensor   # f32[16 T + T]


def pack_tree(scene: Scene, tables: torch.Tensor, counts) -> WalkTree:
    """The ``WalkTree`` of a BVH scene whose ``pack_fwd`` tables and
    counts are ``tables`` and ``counts``."""
    return WalkTree(pack_bvh(scene), pack_walk(tables, counts))


class CullBounds(NamedTuple):
    """The bound tables of ``pack_cull`` (:146-160): supergroup and
    cluster boxes as rows (lo xyz, hi xyz), padded by ``bvh_eps``."""

    sup: torch.Tensor  # f32[n_sup, 6]
    clu: torch.Tensor  # f32[n_clu, 6]
    n_clu: int
    n_sup: int


def is_culled(scene: Scene) -> bool:
    """Whether the JAX ``PathTracer`` takes its culled form for ``scene``
    (:1692-1699): a BVH and 1 to CULL_MAX_TRIS triangles.  Only these
    scenes have ``stats`` counters; the port's BVH form serves any size."""
    return scene.bvh is not None and 0 < scene.num_triangles <= CULL_MAX_TRIS


def pack_cull(scene: Scene) -> CullBounds:
    """The cluster and supergroup boxes of ``pack_cull`` (:118): the
    leaf-ordered triangles windowed into clusters of CULL_K (the last one
    padded with the last triangle's bounds), the clusters into supergroups
    of CULL_G (padded with the last cluster's box); cluster boxes padded by
    ``bvh_eps``.  The port's triangle rows are ``pack_fwd``'s."""
    t = scene.num_triangles
    if not is_culled(scene):
        raise ValueError(f"the culled form needs a BVH scene of 1..{CULL_MAX_TRIS} "
                         f"triangles, got {t} (bvh: {scene.bvh is not None})")
    bmin = torch.minimum(torch.minimum(scene.tri_v0, scene.tri_v1), scene.tri_v2)
    bmax = torch.maximum(torch.maximum(scene.tri_v0, scene.tri_v1), scene.tri_v2)
    eps = bvh_eps(scene)

    def edge_pad(a, n):
        return torch.cat([a, a[-1:].expand(n - a.shape[0], 3)]) if n > a.shape[0] else a

    n_clu = -(-t // CULL_K)
    cb0 = edge_pad(bmin, n_clu * CULL_K).reshape(n_clu, CULL_K, 3).amin(1) - eps
    cb1 = edge_pad(bmax, n_clu * CULL_K).reshape(n_clu, CULL_K, 3).amax(1) + eps
    n_sup = -(-n_clu // CULL_G)
    sb0 = edge_pad(cb0, n_sup * CULL_G).reshape(n_sup, CULL_G, 3).amin(1)
    sb1 = edge_pad(cb1, n_sup * CULL_G).reshape(n_sup, CULL_G, 3).amax(1)
    return CullBounds(torch.cat([sb0, sb1], 1), torch.cat([cb0, cb1], 1),
                      n_clu, n_sup)


def cull_rows(cb: CullBounds) -> torch.Tensor:
    """The stats walk's box rows f32[1 + n_clu, 8]: the root box (the fold
    of the supergroup boxes, :389-393), then each cluster's; lo xyz, hi
    xyz and two unused floats, so a row loads as two float4 like a
    ``pack_bvh`` node."""
    root = torch.cat([cb.sup[:, :3].amin(0), cb.sup[:, 3:].amax(0)])
    rows = torch.cat([root[None], cb.clu])
    return torch.cat([rows, torch.zeros_like(rows[:, :2])], 1).contiguous()


def camera_params(cam, cfg) -> torch.Tensor:
    """f32[24] camera/film parameter vector for ray generation inside the
    trace (the layout of ``rvpt_tpu.ops.pathkernel.camera_params``), on the
    camera's device.  Built on the host in f32 and copied in one transfer;
    callers that draw many frames of one camera build it once
    (``Renderer`` caches it per camera object)."""
    import dataclasses

    from ..core.math import PI
    from ..models.camera import camera_matrix

    host = dataclasses.replace(
        cam, translation=cam.translation.cpu(), rotation=cam.rotation.cpu(),
        fov=cam.fov.cpu(), scale=cam.scale.cpu())
    m = camera_matrix(host)
    if cam.mode == ORTHO:
        proj = host.scale
    else:
        proj = 1.0 / torch.tan(0.5 * host.fov * (PI / 180.0))
    tail = torch.zeros(8, dtype=torch.float32)
    tail[CAM_ASPECT - 16] = cam.aspect
    tail[CAM_PROJ - 16] = proj
    tail[CAM_INV_W - 16] = 1.0 / cfg.width
    tail[CAM_INV_H - 16] = 1.0 / cfg.height
    tail[CAM_W - 16] = float(cfg.width)
    return torch.cat([m.reshape(16), tail]).to(cam.device)


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------


def _f32(x) -> float:
    return float(np.float32(x))


def _safe_den(d):
    return torch.where(torch.abs(d) < _DENOM_EPS, torch.full_like(d, _DENOM_EPS), d)


def _rsqrt_safe(x):
    return torch.rsqrt(torch.clamp(x, min=1e-30))


def _rng(pix, frame, salt):
    return tuple(rng.u32_to_unit_float(x) for x in rng.pcg3d(pix, frame, salt))


def _unpack_fwd(tables, counts, tri_rows=False):
    """The row-form tables as Python rows (triangles, spheres, planes: the
    plain search's scalars) and the [M,8] material tensor; with
    ``tri_rows`` the triangles stay one [T,17] tensor (the vectorized
    triangles-last search's)."""
    t, s, p, nm = counts
    o = 17 * t
    if tri_rows:
        tri = tables[:o].reshape(t, 17)
    else:
        rows = tables[:o].tolist()
        tri = [rows[17 * k:17 * (k + 1)] for k in range(t)]
    flat = tables[o:o + 5 * s + 5 * p].tolist()
    sph = [flat[5 * k:5 * (k + 1)] for k in range(s)]
    o2 = 5 * s
    pln = [flat[o2 + 5 * k:o2 + 5 * (k + 1)] for k in range(p)]
    o += 5 * s + 5 * p
    return tri, sph, pln, tables[o:o + 8 * nm].reshape(nm, 8)


def _mat_fetch(mat, wmat):
    """The winner's material rows [N,8] (``MAT_FIELDS`` columns)."""
    return mat[torch.clamp(wmat.to(torch.int64), 0, mat.shape[0] - 1)]


def _camera_rays_plain(cam, mode, pix, frame, jitter_salt):
    """Jittered camera rays from pixel ids (``_gen_rays_inkernel``): the
    pixel's (x, y) by integer division, jitter from pcg3d(pix, frame,
    jitter_salt).  Products of two camera scalars are rounded to f32."""
    ju32, jv32, _ = rng.pcg3d(pix, frame, jitter_salt)
    ju, jv = rng.u32_to_unit_float(ju32), rng.u32_to_unit_float(jv32)
    width = int(cam[CAM_W])
    xs = (pix % width).to(torch.float32)
    ys = torch.div(pix, width, rounding_mode="floor").to(torch.float32)
    cx = (xs + ju) * cam[CAM_INV_W]
    cy = 1.0 - (ys + jv) * cam[CAM_INV_H]

    def m(r, c):
        return cam[CAM_M + 4 * r + c]

    ones = torch.ones_like(cx)
    if mode == PINHOLE:
        u = cam[CAM_ASPECT] * (2.0 * cx - 1.0)
        v = 2.0 * cy - 1.0
        w = cam[CAM_PROJ]
        dx = m(0, 0) * u + m(0, 1) * v + _f32(np.float32(m(0, 2)) * np.float32(w))
        dy = m(1, 0) * u + m(1, 1) * v + _f32(np.float32(m(1, 2)) * np.float32(w))
        dz = m(2, 0) * u + m(2, 1) * v + _f32(np.float32(m(2, 2)) * np.float32(w))
        inv = _rsqrt_safe(dx * dx + dy * dy + dz * dz)
        return (m(0, 3) * ones, m(1, 3) * ones, m(2, 3) * ones,
                dx * inv, dy * inv, dz * inv)
    if mode == ORTHO:
        u = cam[CAM_ASPECT] * (2.0 * cx - 1.0) * cam[CAM_PROJ]
        v = (2.0 * cy - 1.0) * cam[CAM_PROJ]
        return (m(0, 0) * u + m(0, 1) * v + m(0, 3),
                m(1, 0) * u + m(1, 1) * v + m(1, 3),
                m(2, 0) * u + m(2, 1) * v + m(2, 3),
                m(0, 2) * ones, m(1, 2) * ones, m(2, 2) * ones)
    phi = cx * _TWO_PI
    theta = cy * (0.5 * _TWO_PI)
    sin_t = torch.sin(theta)
    lx = sin_t * torch.cos(phi)
    lz = sin_t * torch.sin(phi)  # .xzy swizzle (camera.glsl:95)
    ly = torch.cos(theta)
    return (m(0, 3) * ones, m(1, 3) * ones, m(2, 3) * ones,
            m(0, 0) * lx + m(0, 1) * ly + m(0, 2) * lz,
            m(1, 0) * lx + m(1, 1) * ly + m(1, 2) * lz,
            m(2, 0) * lx + m(2, 1) * ly + m(2, 2) * lz)


def _search_plain(tri, sph, pln, ox, oy, oz, dx, dy, dz, mint):
    """Closest hit over triangles, spheres, planes (``_search``): a
    candidate wins only with a strictly smaller t, so the first minimum
    wins within a family and the earlier family across families.
    Returns the winner (t, normal xyz, material id, family, index) in the
    JAX kernel's order; family and index are int32, -1 on a miss."""
    big = torch.full_like(ox, _BIG)
    t_best = big
    wnx = torch.zeros_like(ox)
    wny = torch.zeros_like(ox)
    wnz = torch.zeros_like(ox)
    wmat = torch.zeros_like(ox)
    wfam = torch.full_like(ox, -1, dtype=torch.int32)
    widx = torch.full_like(ox, -1, dtype=torch.int32)

    def take(valid, t, nx, ny, nz, mat, fam, idx):
        nonlocal t_best, wnx, wny, wnz, wmat, wfam, widx
        t_best = torch.where(valid, t, t_best)
        wnx = torch.where(valid, nx, wnx)
        wny = torch.where(valid, ny, wny)
        wnz = torch.where(valid, nz, wnz)
        wmat = torch.where(valid, mat, wmat)
        wfam = torch.where(valid, fam, wfam)
        widx = torch.where(valid, idx, widx)

    for j, (nx, ny, nz, e0x, e0y, e0z, e1x, e1y, e1z, v0n, v0e0, v0e1,
            g00, g11, g01, inv_det, mat) in enumerate(tri):
        dn = nx * dx + ny * dy + nz * dz
        on = nx * ox + ny * oy + nz * oz
        de0 = e0x * dx + e0y * dy + e0z * dz
        de1 = e1x * dx + e1y * dy + e1z * dz
        oe0 = e0x * ox + e0y * oy + e0z * oz
        oe1 = e1x * ox + e1y * oy + e1z * oz
        t = (v0n - on) / _safe_den(dn)
        b0 = oe0 + t * de0 - v0e0
        b1 = oe1 + t * de1 - v0e1
        u = inv_det * (g11 * b0 - g01 * b1)
        v = inv_det * (g00 * b1 - g01 * b0)
        valid = (mint < t) & (t < t_best) & (u > 0.0) & (v > 0.0) & (u + v < 1.0)
        take(valid, t, nx, ny, nz, mat, 0, j)

    for j, (cx, cy, cz, rad, mat) in enumerate(sph):
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        dd = dx * dx + dy * dy + dz * dz
        bh = dx * ocx + dy * ocy + dz * ocz
        ct = ocx * ocx + ocy * ocy + ocz * ocz - _f32(np.float32(rad) * np.float32(rad))
        disc = bh * bh - dd * ct
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        dds = _safe_den(dd)
        t0 = (-bh - sq) / dds
        t1 = (-bh + sq) / dds
        tn = torch.where((t0 > mint) & (t0 < t_best), t0, big)
        tf = torch.where((t1 > mint) & (t1 < t_best), t1, big)
        ts = torch.minimum(tn, tf) if rad > 0.0 else big
        ts = torch.where(disc > 0.0, ts, big)
        valid = ts < t_best
        take(valid, ts, ox + ts * dx - cx, oy + ts * dy - cy, oz + ts * dz - cz,
             mat, 1, j)

    for j, (nx, ny, nz, doff, mat) in enumerate(pln):
        if not float(np.float32(nx) * np.float32(nx) + np.float32(ny) * np.float32(ny)
                     + np.float32(nz) * np.float32(nz)) > 0.0:
            continue  # zero normal: never a valid plane
        dn = nx * dx + ny * dy + nz * dz
        on = nx * ox + ny * oy + nz * oz
        tp = (doff - on) / _safe_den(dn)
        valid = (tp > mint) & (tp < t_best)
        take(valid, tp, nx, ny, nz, mat, 2, j)

    return t_best, wnx, wny, wnz, wmat, wfam, widx


# Elements of one [rays, triangles] block of the vectorized plain searches
# (each of their temporaries is one such block).
_PLAIN_BLOCK = 1 << 24


def _any_hit_plain(tri, sph, pln, ox, oy, oz, dx, dy, dz, mint):
    """Whether each ray hits anything, as the row form's any-hit search
    decides it (``occluded``, csrc/scene_search.cuh: K1's Whitted shadow
    rays, B3's AO probes and Appel shadow rays): the spheres and planes
    (``_search_plain``'s), then the [T,17] triangle rows ``tri`` in order
    up to the first that passes the closest-hit acceptance against the
    miss sentinel (mint < t < 3e38 and the u, v test).  Equal to
    ``_search_plain``'s family >= 0, because a closest-hit search only
    ever tightens its best t below the sentinel.  Returns (hit bool[N], the
    triangle rows it opens int64[N], the rows it tests in full past the
    t-first reject int64[N]); a lane whose sphere or plane hit opens none."""
    hit = _search_plain([], sph, pln, ox, oy, oz, dx, dy, dz, mint)[5] >= 0
    opened = torch.zeros_like(ox, dtype=torch.int64)
    full = torch.zeros_like(opened)
    n, n_tri = ox.shape[0], tri.shape[0]
    block = max(1, min(n_tri, _PLAIN_BLOCK // max(n, 1)))
    rb = [c[:, None] for c in (ox, oy, oz, dx, dy, dz)]
    for base in range(0, n_tri, block):
        t, ok = _tri_block(tri[base:base + block], *rb, mint)
        width = t.shape[1]
        passed = (mint < t) & (t < _BIG)
        accept = ok & passed
        # Rows this block opens on lanes still searching: up to and with
        # the first acceptance, else all of them.
        iota = torch.arange(width, device=t.device)
        first = torch.where(accept, iota, width).amin(1)
        seen = iota[None, :] <= first[:, None]
        searching = ~hit
        opened += torch.where(searching, torch.clamp(first + 1, max=width), 0)
        full += torch.where(searching, (passed & seen).sum(1), 0)
        hit = hit | accept.any(1)
    return hit, opened, full


def _tri_block(rows, oxb, oyb, ozb, dxb, dyb, dzb, mint):
    """The metric-tensor test of every [T,17] triangle row against every
    ray ([N,1] components) -> (t, hit) f32/bool[N, T]: ``_search_plain``'s
    arithmetic, ``hit`` its validity test but the ``t < t_best`` one."""
    (nx, ny, nz, e0x, e0y, e0z, e1x, e1y, e1z, v0n, v0e0, v0e1, g00, g11,
     g01, inv_det, _) = (c[None, :] for c in rows.unbind(1))
    dn = nx * dxb + ny * dyb + nz * dzb
    on = nx * oxb + ny * oyb + nz * ozb
    de0 = e0x * dxb + e0y * dyb + e0z * dzb
    de1 = e1x * dxb + e1y * dyb + e1z * dzb
    oe0 = e0x * oxb + e0y * oyb + e0z * ozb
    oe1 = e1x * oxb + e1y * oyb + e1z * ozb
    t = (v0n - on) / _safe_den(dn)
    b0 = oe0 + t * de0 - v0e0
    b1 = oe1 + t * de1 - v0e1
    u = inv_det * (g11 * b0 - g01 * b1)
    v = inv_det * (g00 * b1 - g01 * b0)
    return t, (mint < t) & (u > 0.0) & (v > 0.0) & (u + v < 1.0)


def _search_tris_last(tri, sph, pln, ox, oy, oz, dx, dy, dz, mint, live=None):
    """Closest hit with the triangles LAST, the order of the culled and
    big-mesh searches (``_search`` :828-835, ``_culled_tris_rows``): the
    spheres and planes as ``_search_plain``, then every row of the [T,17]
    triangle tensor ``tri`` (leaf order), which wins only with a strictly
    smaller t.  So a sphere or plane keeps an exact tie with a triangle,
    and among triangles the lowest index wins a tie.  Vectorized over
    [rays, triangle block] blocks; each element's arithmetic is
    ``_search_plain``'s, so the two round alike.  Lanes outside ``live``
    search nothing and get the miss winner."""
    if live is not None and not bool(live.all()):
        lanes = torch.nonzero(live).squeeze(1)
        sub = _search_tris_last(tri, sph, pln, *(c[lanes] for c in (
            ox, oy, oz, dx, dy, dz)), mint)
        out = _search_plain([], [], [], ox, oy, oz, dx, dy, dz, mint)
        for w, v in zip(out, sub):
            w[lanes] = v
        return out
    t_best, wnx, wny, wnz, wmat, wfam, widx = _search_plain(
        [], sph, pln, ox, oy, oz, dx, dy, dz, mint)
    n, n_tri = ox.shape[0], tri.shape[0]
    block = max(1, min(n_tri, _PLAIN_BLOCK // max(n, 1)))
    oxb, oyb, ozb, dxb, dyb, dzb = (c[:, None] for c in (ox, oy, oz, dx, dy, dz))
    for base in range(0, n_tri, block):
        rows = tri[base:base + block]
        t, hit = _tri_block(rows, oxb, oyb, ozb, dxb, dyb, dzb, mint)
        valid = hit & (t < t_best[:, None])
        cmin, first = _min_and_first_index(
            torch.where(valid, t, torch.full_like(t, _BIG)), dim=1)
        better = cmin < t_best
        t_best = torch.where(better, cmin, t_best)
        wnx = torch.where(better, rows[first, 0], wnx)
        wny = torch.where(better, rows[first, 1], wny)
        wnz = torch.where(better, rows[first, 2], wnz)
        wmat = torch.where(better, rows[first, 16], wmat)
        wfam = torch.where(better, 0, wfam)
        widx = torch.where(better, (base + first).to(torch.int32), widx)
    return t_best, wnx, wny, wnz, wmat, wfam, widx


def _plain_search(tables, counts, mint, tris_last, on_search=None):
    """(search, material rows) of the plain versions: ``search(o3, d3,
    live=None)`` -> winner for the rays with origin ``o3`` and direction
    ``d3`` ((x, y, z) tuples of f32[N]), the row form's ``_search_plain``
    (every lane; ``live`` unused) or, with ``tris_last``, the BVH forms'
    ``_search_tris_last``.  ``on_search``, if given, is called with
    ``(o3, d3, live)`` of every search first (``live`` None for every
    lane), so a bound can count the work the kernel does on those rays
    (``count_bvh_walk``)."""
    tri, sph, pln, mat = _unpack_fwd(tables, counts, tri_rows=tris_last)

    def search(o3, d3, live=None):
        if on_search is not None:
            on_search(o3, d3, live)
        if not tris_last:
            return _search_plain(tri, sph, pln, *o3, *d3, mint)
        return _search_tris_last(tri, sph, pln, *o3, *d3, mint, live)

    return search, mat


def _slab_plain(rows, o3, iv, mint):
    """Slab test of every ray against every box row (lo xyz, hi xyz) ->
    (hit bool[N, B], entry t0 f32[N, B]): ``_culled_tris``' slab (:357)."""
    lo = [rows[None, :, k] for k in range(3)]
    hi = [rows[None, :, 3 + k] for k in range(3)]
    f0 = [(lo[k] - o3[k][:, None]) * iv[k][:, None] for k in range(3)]
    f1 = [(hi[k] - o3[k][:, None]) * iv[k][:, None] for k in range(3)]
    mn = [torch.minimum(a, b) for a, b in zip(f0, f1)]
    mx = [torch.maximum(a, b) for a, b in zip(f0, f1)]
    t0 = torch.maximum(torch.maximum(mn[0], mn[1]),
                       torch.clamp(mn[2], min=float(mint)))
    t1 = torch.minimum(torch.minimum(mx[0], mx[1]), mx[2])
    return t1 >= t0, t0


def cull_stats_plain(tri, sph, pln, rows, o3, d3, live, mint=0.0):
    """The clusters each ray of one search lists and still passes in the
    culled walk (``_culled_tris`` :371-470), per lane -> (listed, passed)
    bool[N, n_clu].

    ``tri`` the leaf-ordered [T,17] rows, ``sph``/``pln`` the sphere and
    plane rows (``_unpack_fwd``), ``rows`` the ``cull_rows`` boxes.  A
    lane that is ``live`` and enters the root box lists every cluster
    whose box it enters; it passes a listed cluster when its entry t0 is
    below the lane's best t before that cluster: the sphere/plane winner
    tightened by its triangle hits in the clusters before (an exclusive
    running minimum in id order).  The tile's counts are the sizes of the
    unions of these sets over its lanes (``cull_stats_hook``)."""
    n, n_clu = o3[0].shape[0], rows.shape[0] - 1
    iv = [1.0 / _safe_den(c) for c in d3]
    root, _ = _slab_plain(rows[:1], o3, iv, mint)
    hit, t0 = _slab_plain(rows[1:], o3, iv, mint)
    listed = hit & (live & root[:, 0])[:, None]
    seed = _search_plain([], sph, pln, *o3, *d3, mint)[0]
    # Each lane's nearest triangle hit per cluster, the pad rows a miss.
    tmin = torch.full((n, n_clu * CULL_K), _BIG, dtype=torch.float32,
                      device=seed.device)
    n_tri = tri.shape[0]
    block = max(CULL_K, _PLAIN_BLOCK // max(n, 1) // CULL_K * CULL_K)
    rb = [c[:, None] for c in (*o3, *d3)]
    for base in range(0, n_tri, block):
        t, ok = _tri_block(tri[base:base + block], *rb, mint)
        tmin[:, base:base + t.shape[1]] = torch.where(ok, t, _BIG)
    cmin = tmin.reshape(n, n_clu, CULL_K).amin(2)
    before = torch.cummin(torch.cat([seed[:, None], cmin[:, :-1]], 1), 1)[0]
    return listed, listed & (t0 < before)


def cull_stats_hook(tables, counts, rows, n, acc, mint=0.0, work=None):
    """An ``on_search`` hook that adds each search's culled-walk counters
    to ``acc`` f32[3, ceil(n / CULL_TILE)] (listed, processed, still
    passed), tile by tile of CULL_TILE consecutive rays: the number of
    clusters some live lane of the tile lists, and still passes
    (``cull_stats_plain``).  Processed equals listed (:470).  A dict passed
    as ``work`` gets the tests the counting instance runs on these rays,
    for a bound: "root" box tests (one per live lane), "clusters" (n_clu
    per lane inside the root box), "bits" (listed and passed bits set) and
    "tris" (each passed cluster's triangles)."""
    tri, sph, pln, _ = _unpack_fwd(tables, counts, tri_rows=True)
    n_clu = rows.shape[0] - 1
    sizes = torch.clamp(counts[0] - CULL_K * torch.arange(n_clu, device=rows.device),
                        max=CULL_K).to(torch.float32)

    def count(key, value):
        work[key] = work.get(key, 0) + int(value)

    def on_search(o3, d3, live=None):
        if live is None:
            live = torch.ones_like(o3[0], dtype=torch.bool)
        for k, start in enumerate(range(0, n, CULL_TILE)):
            lanes = torch.nonzero(live[start:start + CULL_TILE]).squeeze(1) + start
            if lanes.numel() == 0:
                continue
            o_t, d_t = tuple(c[lanes] for c in o3), tuple(c[lanes] for c in d3)
            listed, passed = cull_stats_plain(
                tri, sph, pln, rows, o_t, d_t,
                torch.ones_like(lanes, dtype=torch.bool), mint)
            if work is not None:
                iv = [1.0 / _safe_den(c) for c in d_t]
                inside = int(_slab_plain(rows[:1], o_t, iv, mint)[0].sum())
                count("root", lanes.numel())
                count("clusters", inside * n_clu)
                count("bits", listed.sum() + passed.sum())
                count("tris", (passed.to(torch.float32) @ sizes).sum())
            n_listed = listed.any(0).sum().to(acc.dtype)
            acc[0, k] += n_listed
            acc[1, k] += n_listed
            acc[2, k] += passed.any(0).sum().to(acc.dtype)

    return on_search


def _sky_add(rr, rg, rb, cr, cg, cb, tr, tg, tb, sky_t, mask):
    """Add the gathered color and the sky behind ``mask``'s lanes."""
    rr = torch.where(mask, rr + cr + tr * (_WHITE[0] + _SKY[0] * sky_t), rr)
    rg = torch.where(mask, rg + cg + tg * (_WHITE[1] + _SKY[1] * sky_t), rg)
    rb = torch.where(mask, rb + cb + tb * (_WHITE[2] + _SKY[2] * sky_t), rb)
    return rr, rg, rb


def _shade_geom_plain(pix, frame, salt, ox, oy, oz, dx, dy, dz, winner, ior,
                      kind):
    """Hit geometry and scatter directions shared by the bounce integrators
    (``_shade_geom`` :857): hit point, flipped unit normal, the Lambert /
    mirror / dielectric candidate directions and the stochastic Fresnel
    choice.  Returns (px, py, pz, nX, nY, nZ, out dx, dy, dz, offset,
    is_lam)."""
    t_best, wnx, wny, wnz = winner[:4]
    px = ox + t_best * dx
    py = oy + t_best * dy
    pz = oz + t_best * dz
    inv_nl = _rsqrt_safe(wnx * wnx + wny * wny + wnz * wnz)
    nX, nY, nZ = wnx * inv_nl, wny * inv_nl, wnz * inv_nl
    inv_dl = _rsqrt_safe(dx * dx + dy * dy + dz * dz)
    iX, iY, iZ = dx * inv_dl, dy * inv_dl, dz * inv_dl

    cos_view = iX * nX + iY * nY + iZ * nZ
    flipped = cos_view > 0.0
    cos_in = torch.abs(cos_view)
    nX = torch.where(flipped, -nX, nX)
    nY = torch.where(flipped, -nY, nY)
    nZ = torch.where(flipped, -nZ, nZ)
    eta = torch.where(flipped, ior, 1.0 / torch.clamp(ior, min=1e-8))

    ru, rv, rw = _rng(pix, frame, salt)

    phi = _TWO_PI * ru
    cos_t = 1.0 - 2.0 * rv
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    lamX = nX + sin_t * torch.cos(phi)
    lamY = nY + sin_t * torch.sin(phi)
    lamZ = nZ + cos_t

    refX = iX + 2.0 * cos_in * nX
    refY = iY + 2.0 * cos_in * nY
    refZ = iZ + 2.0 * cos_in * nZ

    cos_out_sqr = 1.0 - eta * eta * (1.0 - cos_in * cos_in)
    cos_out = torch.sqrt(torch.clamp(cos_out_sqr, min=0.0))
    r_perp = (eta * cos_in - cos_out) / (eta * cos_in + cos_out)
    r_par = (cos_in - eta * cos_out) / (cos_in + eta * cos_out)
    f_refl = 0.5 * (r_perp * r_perp + r_par * r_par)
    refl = (cos_out_sqr <= 0.0) | (rw < f_refl)
    k = eta * cos_in - cos_out
    dieX = torch.where(refl, refX, eta * iX + k * nX)
    dieY = torch.where(refl, refY, eta * iY + k * nY)
    dieZ = torch.where(refl, refZ, eta * iZ + k * nZ)
    die_off = torch.where(refl, _EPSILON, -_EPSILON)

    is_lam = kind == 0.0
    is_mir = kind == 1.0
    out_dx = torch.where(is_lam, lamX, torch.where(is_mir, refX, dieX))
    out_dy = torch.where(is_lam, lamY, torch.where(is_mir, refY, dieY))
    out_dz = torch.where(is_lam, lamZ, torch.where(is_mir, refZ, dieZ))
    off = torch.where(is_lam | is_mir, _EPSILON, die_off)
    return px, py, pz, nX, nY, nZ, out_dx, out_dy, out_dz, off, is_lam


def _no_count(key, mask):
    """The work counter of a plain version run without a ``work`` dict."""


def _shade_plain(integ, mat, pix, frame, salt, state, winner, final, search,
                 count=_no_count):
    """One bounce of a bounce integrator at a search's winner, shape-
    generic plain tensor code: Kajiya (``_shade`` :925), Whitted
    (``_shade_whitted`` :961: a Lambert hit casts a shadow ray with
    ``search(o3, d3, live)`` and ends) or Cook (``_shade_cook`` :1016:
    a lane whose previous bounce scattered off Lambert, ``final``, ends on
    this hit's emission).  ``state`` holds the 15 carries (``STATE_FIELDS``)
    and the bool ``active``; returns (the new state, the new ``final``).
    ``count(key, mask)`` receives the lanes of each kind of work (see
    ``trace_plain``)."""
    ox, oy, oz, dx, dy, dz, tr, tg, tb, cr, cg, cb, rr, rg, rb, active = state
    hit = winner[5] >= 0
    # Kajiya shifts d.y into [0,1] (integrators.glsl:579); Whitted and
    # Cook use raw d.y.
    sky_t = dy * 0.5 + 0.5 if integ == "kajiya" else dy
    count("end", active & ~hit)
    rr, rg, rb = _sky_add(rr, rg, rb, cr, cg, cb, tr, tg, tb, sky_t,
                          active & ~hit)
    active = active & hit

    m = _mat_fetch(mat, winner[4])
    if integ == "cook":
        fin_now = active & final
        count("end", fin_now)
        rr = torch.where(fin_now, rr + cr + tr * m[:, 3], rr)
        rg = torch.where(fin_now, rg + cg + tg * m[:, 4], rg)
        rb = torch.where(fin_now, rb + cb + tb * m[:, 5], rb)
        active = active & ~final
    cr = torch.where(active, cr + tr * m[:, 3], cr)
    cg = torch.where(active, cg + tg * m[:, 4], cg)
    cb = torch.where(active, cb + tb * m[:, 5], cb)

    (px, py, pz, nX, nY, nZ, out_dx, out_dy, out_dz, off,
     lam) = _shade_geom_plain(pix, frame, salt, ox, oy, oz, dx, dy, dz,
                              winner, m[:, 6], m[:, 7])

    if integ == "whitted":
        # Lambert lanes: a shadow ray toward the directional light, then
        # the path ends.
        is_lam = active & lam
        count("search", is_lam)
        count("lambert", is_lam)
        ones = torch.ones_like(ox)
        sw = search((px + _EPSILON * nX, py + _EPSILON * nY, pz + _EPSILON * nZ),
                    (_LDIR[0] * ones, _LDIR[1] * ones, _LDIR[2] * ones), is_lam)
        in_shadow = (sw[5] >= 0) & is_lam
        cos_l = torch.clamp(_LDIR[0] * nX + _LDIR[1] * nY + _LDIR[2] * nZ,
                            min=0.0)
        lit = _LIGHT_I * cos_l
        lam_r = torch.where(in_shadow, cr, cr + tr * m[:, 0] * lit)
        lam_g = torch.where(in_shadow, cg, cg + tg * m[:, 1] * lit)
        lam_b = torch.where(in_shadow, cb, cb + tb * m[:, 2] * lit)
        rr = torch.where(is_lam, rr + lam_r, rr)
        rg = torch.where(is_lam, rg + lam_g, rg)
        rb = torch.where(is_lam, rb + lam_b, rb)
        active = active & ~is_lam
    elif integ == "cook":
        final = active & lam
    count("scatter", active)

    ox = torch.where(active, px + off * nX, ox)
    oy = torch.where(active, py + off * nY, oy)
    oz = torch.where(active, pz + off * nZ, oz)
    dx = torch.where(active, out_dx, dx)
    dy = torch.where(active, out_dy, dy)
    dz = torch.where(active, out_dz, dz)
    tr = torch.where(active, tr * m[:, 0], tr)
    tg = torch.where(active, tg * m[:, 1], tg)
    tb = torch.where(active, tb * m[:, 2], tb)
    return (ox, oy, oz, dx, dy, dz, tr, tg, tb, cr, cg, cb, rr, rg, rb,
            active), final


def _finish_plain(integ, style, state, final, search, mat, count=_no_count):
    """After the last bounce -> f32[3, N]: Cook's tail (a Lambert scatter
    on the last bounce still resolves: one more search, ending on emission
    or the sky, :1235-1253), then ``style="standard"``'s gathered color of
    the lanes still active (:1254-1257)."""
    ox, oy, oz, dx, dy, dz, tr, tg, tb, cr, cg, cb, rr, rg, rb, active = state
    if integ == "cook" and final is not None:
        fin = active & final
        count("search", fin)
        count("end", fin)
        tw = search((ox, oy, oz), (dx, dy, dz), fin)
        m2 = _mat_fetch(mat, tw[4])
        hit2 = tw[5] >= 0
        rr = torch.where(fin, rr + cr + tr * torch.where(
            hit2, m2[:, 3], _WHITE[0] + _SKY[0] * dy), rr)
        rg = torch.where(fin, rg + cg + tg * torch.where(
            hit2, m2[:, 4], _WHITE[1] + _SKY[1] * dy), rg)
        rb = torch.where(fin, rb + cb + tb * torch.where(
            hit2, m2[:, 5], _WHITE[2] + _SKY[2] * dy), rb)
        active = active & ~final
    if style == "standard":
        rr = torch.where(active, rr + cr, rr)
        rg = torch.where(active, rg + cg, rg)
        rb = torch.where(active, rb + cb, rb)
    return torch.stack([rr, rg, rb])


def _start_state(rays, integ):
    """The carries at a path's start (``STATE_FIELDS``): unit throughput,
    the gathered color zero (Whitted: the ambient term, :1183-1186), no
    radiance, every lane active."""
    ox = rays[0]
    ones, zeros = torch.ones_like(ox), torch.zeros_like(ox)
    c0 = torch.full_like(ox, _AMBIENT) if integ == "whitted" else zeros
    return (*rays, ones, ones, ones, c0, c0, c0, zeros, zeros, zeros,
            torch.ones_like(ox, dtype=torch.bool))


def trace_plain(tables, counts, pix, frame, salt_base, max_bounces, style,
                rays=None, cam_params=None, cam_mode=PINHOLE, jitter_salt=0,
                mint=0.0, collect=False, integ="kajiya", work=None,
                tris_last=False, on_search=None):
    """The plain PyTorch version of the whole-path kernel -> f32[3, N], or
    (f32[3, N], ``PathRecord``) with ``collect``.

    ``tables``/``counts`` from ``pack_fwd``; ``pix`` int64[N] pixel ids;
    ``rays`` six f32[N] components (ox, oy, oz, dx, dy, dz) or None to
    generate camera rays from ``cam_params``.  The bounce-b RNG salt is
    ``salt_base + 4 b``.  ``integ`` is the bounce integrator: "kajiya",
    "whitted" (a shadow search per Lambert hit, which ends the path) or
    "cook" (a Lambert scatter ends on the next hit's emission or the sky,
    with one tail search after the last bounce).  ``tris_last`` searches
    as K1's BVH form does (a BVH scene's leaf-ordered tables, triangles
    after spheres and planes: ``_search_tris_last``), otherwise as its row
    form.  Mirrors ``_search``, ``_shade``, ``_shade_whitted``,
    ``_shade_cook``, the Cook tail (:1235-1253) and the ``collect`` records
    (:1202-1215) of the JAX kernel line for line; records are a
    Kajiya-only path (:1718).  ``collect="hits"`` (K1's hits-only collect
    instance) returns (f32[3, N], int32[B, 2, N]): only the record's hits,
    as ``PathRecord.hits``.  A dict passed as ``work`` gets the lanes of
    the work the kernel does on this data, for a bound: "search" every
    closest-hit search of a live lane (bounce, Whitted shadow and Cook tail
    searches), "scatter" every hit that runs the scatter shading and its
    random draw, "lambert" every Whitted Lambert hit (shadow ray and direct
    term, no scatter) and "end" every lane that ends on the sky or on
    Cook's emission.  ``on_search`` sees the rays of every search
    (``_plain_search``)."""
    if integ not in INTEGS:
        raise ValueError(f"unknown integrator {integ!r}")
    if collect not in (False, True, "hits"):
        raise ValueError(f"collect must be False, True or 'hits', got {collect!r}")
    if integ != "kajiya" and collect:
        raise ValueError("hit records are a Kajiya-only path")
    search, mat = _plain_search(tables, counts, mint, tris_last, on_search)

    if rays is None:
        rays = _camera_rays_plain(cam_params.tolist(), cam_mode, pix, frame,
                                  jitter_salt)
    state = _start_state(tuple(rays), integ)
    final = torch.zeros_like(state[15])
    rec_fields, rec_hits = [], []

    def count(key, mask):
        if work is not None:
            work[key] = work.get(key, 0) + int(mask.sum())

    nb = int(max_bounces)
    for b in range(nb):
        active = state[15]
        if collect is True:
            rec_fields.append(torch.stack([*state[:12], active.to(torch.float32)]))
        count("search", active)
        winner = search(state[:3], state[3:6], active)
        if collect:
            live_hit = active & (winner[5] >= 0)
            rec_hits.append(torch.stack([torch.where(live_hit, winner[5], -1),
                                         torch.where(live_hit, winner[6], -1)]))
        state, final = _shade_plain(integ, mat, pix, frame, salt_base + 4 * b,
                                    state, winner, final, search, count)
    out = _finish_plain(integ, style, state, final if nb else None, search, mat,
                        count)
    if not collect:
        return out
    hits = (torch.stack(rec_hits) if nb else
            torch.empty((0, 2, out.shape[1]), dtype=torch.int32, device=out.device))
    if collect == "hits":
        return out, hits
    return out, PathRecord(torch.stack(rec_fields), hits)


def _primary_finalize(mode, nrays, mat, pix, frame, salt_base, rays, winner,
                      search):
    """Debug-integrator finalize from a primary-hit winner (``_primary_
    finalize`` :3289-3387; integrators.glsl:24-250).  Shape-generic plain
    tensor code: ``rays`` the six ray components, ``winner`` the search's
    (t, normal xyz, material id, family, index), ``mat`` the [M,8]
    material rows, and ``search(o3, d3, mask) -> winner`` the AO probe and
    Appel shadow searches.  Returns (r, g, b)."""
    ox, oy, oz, dx, dy, dz = rays
    t, wnx, wny, wnz, wmat, wfam, _ = winner
    hit = wfam >= 0
    hit_f = hit.to(torch.float32)
    zeros = torch.zeros_like(dx)
    inv_nl = _rsqrt_safe(wnx * wnx + wny * wny + wnz * wnz)
    # Normalized, zeroed on a miss (isect_from_hit's convention).
    nX = torch.where(hit, wnx * inv_nl, zeros)
    nY = torch.where(hit, wny * inv_nl, zeros)
    nZ = torch.where(hit, wnz * inv_nl, zeros)
    m = _mat_fetch(mat, wmat)

    if mode == 0:       # binary (integrators.glsl:24-38)
        return hit_f, hit_f, hit_f
    if mode == 1:       # color (42-59)
        return tuple(torch.where(hit, m[:, k], zeros) for k in range(3))
    if mode == 2:       # depth (63-82): rsqrt(|d|^2)/t; miss -> 0
        inv_d = _rsqrt_safe(dx * dx + dy * dy + dz * dz)
        v = torch.where(hit, inv_d / torch.clamp(t, min=1e-30), zeros)
        return v, v, v
    if mode == 3:       # normal (86-102)
        return (0.5 * nX + 0.5 * hit_f, 0.5 * nY + 0.5 * hit_f,
                0.5 * nZ + 0.5 * hit_f)
    if mode == 4:       # Utah (106-148): raster shading, no shadows
        facing = (dx * nX + dy * nY + dz * nZ) < 0.0
        fX = torch.where(facing, nX, -nX)
        fY = torch.where(facing, nY, -nY)
        fZ = torch.where(facing, nZ, -nZ)
        cos_l = torch.clamp(_LDIR[0] * fX + _LDIR[1] * fY + _LDIR[2] * fZ,
                            min=0.0)
        # The sky uses RAW d.y (glsl mix extrapolates outside [0,1]).
        return tuple(
            torch.where(hit, _AMBIENT + m[:, 3 + k] + m[:, k] * (_LIGHT_I * cos_l),
                        _WHITE[k] + _SKY[k] * dy)
            for k in range(3))

    inv_dl = _rsqrt_safe(dx * dx + dy * dy + dz * dz)
    iX, iY, iZ = dx * inv_dl, dy * inv_dl, dz * inv_dl
    if mode == 5:       # AO (152-200): nrays cosine probes
        facing = (iX * nX + iY * nY + iZ * nZ) < 0.0
        fX = torch.where(facing, nX, -nX)
        fY = torch.where(facing, nY, -nY)
        fZ = torch.where(facing, nZ, -nZ)
        px = ox + t * dx + _EPSILON * fX
        py = oy + t * dy + _EPSILON * fY
        pz = oz + t * dz + _EPSILON * fZ
        acc = zeros
        for i in range(nrays):
            ru, rv, _ = _rng(pix, frame, salt_base + i * 4)
            phi = _TWO_PI * ru
            cos_t = 1.0 - 2.0 * rv
            sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
            pw = search((px, py, pz), (fX + sin_t * torch.cos(phi),
                                       fY + sin_t * torch.sin(phi), fZ + cos_t),
                        hit)
            acc = acc + ((pw[5] >= 0) & hit).to(torch.float32)
        ao = 1.0 - acc * (1.0 / nrays)
        v = torch.where(hit, ao, zeros)
        return v, v, v
    # Appel (204-250): a hard shadow; a miss is white.
    flip = (iX * nX + iY * nY + iZ * nZ) > 0.0
    fX = torch.where(flip, -nX, nX)
    fY = torch.where(flip, -nY, nY)
    fZ = torch.where(flip, -nZ, nZ)
    px = ox + t * dx + _EPSILON * fX
    py = oy + t * dy + _EPSILON * fY
    pz = oz + t * dz + _EPSILON * fZ
    ones = torch.ones_like(dx)
    sw = search((px, py, pz), (_LDIR[0] * ones, _LDIR[1] * ones, _LDIR[2] * ones),
                hit)
    shadow = (sw[5] >= 0) & hit
    cos_l = torch.clamp(_LDIR[0] * fX + _LDIR[1] * fY + _LDIR[2] * fZ, min=0.0)
    lit = torch.where(shadow, zeros, _LIGHT_I * cos_l)
    v = torch.where(hit, lit, ones)
    return v, v, v


def primary_plain(tables, counts, pix, frame, salt_base, mode, nrays,
                  cam_params, cam_mode=PINHOLE, jitter_salt=0, mint=0.0,
                  tris_last=False, on_search=None, rays=None):
    """The plain PyTorch version of the primary-hit kernel -> f32[3, N]:
    camera rays from ``pix`` (int64[N]), or the six f32[N] ray components
    ``rays`` (B3's rays-in form; ``cam_params`` unused), one closest hit,
    then the finalize of debug ``mode`` (``PRIMARY_MODES``); AO casts
    ``nrays`` cosine probes with salts ``salt_base + 4 i``.  ``tris_last``
    searches as B3's BVH form does; ``on_search`` sees the rays of every
    search (``_plain_search``)."""
    if mode not in PRIMARY_MODES:
        raise ValueError(f"mode {mode} is not a primary-hit mode")
    search, mat = _plain_search(tables, counts, mint, tris_last, on_search)
    if rays is None:
        rays = _camera_rays_plain(cam_params.tolist(), cam_mode, pix, frame,
                                  jitter_salt)
    winner = search(rays[:3], rays[3:])
    return torch.stack(_primary_finalize(mode, int(nrays), mat, pix, frame,
                                         salt_base, rays, winner, search))


def _tri_dist2(px, py, pz, ax, ay, az, bx, by, bz, cx, cy, cz):
    """Squared iq unsigned triangle distance (``_tri_dist2`` :3518,
    distance_functions.glsl:28-61), broadcast-generic over the point and
    vertex components."""
    bax, bay, baz = bx - ax, by - ay, bz - az
    cbx, cby, cbz = cx - bx, cy - by, cz - bz
    acx, acy, acz = ax - cx, ay - cy, az - cz
    # nor = cross(ba, ac)
    nx = bay * acz - baz * acy
    ny = baz * acx - bax * acz
    nz = bax * acy - bay * acx
    pax, pay, paz = px - ax, py - ay, pz - az
    pbx, pby, pbz = px - bx, py - by, pz - bz
    pcx, pcy, pcz = px - cx, py - cy, pz - cz

    def edge_sign(ex, ey, ez, qx, qy, qz):
        # sign(dot(cross(e, nor), q))
        cxx = ey * nz - ez * ny
        cyy = ez * nx - ex * nz
        czz = ex * ny - ey * nx
        return torch.sign(cxx * qx + cyy * qy + czz * qz)

    edge_region = (
        edge_sign(bax, bay, baz, pax, pay, paz)
        + edge_sign(cbx, cby, cbz, pbx, pby, pbz)
        + edge_sign(acx, acy, acz, pcx, pcy, pcz)
    ) < 2.0

    def edge_dist(ex, ey, ez, qx, qy, qz):
        e2 = torch.clamp(ex * ex + ey * ey + ez * ez, min=1e-20)
        h = torch.clamp((ex * qx + ey * qy + ez * qz) / e2, 0.0, 1.0)
        rx, ry, rz = ex * h - qx, ey * h - qy, ez * h - qz
        return rx * rx + ry * ry + rz * rz

    d_edge = torch.minimum(
        torch.minimum(edge_dist(bax, bay, baz, pax, pay, paz),
                      edge_dist(cbx, cby, cbz, pbx, pby, pbz)),
        edge_dist(acx, acy, acz, pcx, pcy, pcz))
    dn = nx * pax + ny * pay + nz * paz
    d_face = dn * dn / torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-20)
    return torch.where(edge_region, d_edge, d_face)


def hart_plain(htables, n_tri, pix, frame, cam_params, cam_mode=PINHOLE,
               jitter_salt=0, mint=0.0, tri_chunk=16):
    """The plain PyTorch version of the Hart march kernel -> f32[3, N]:
    camera rays from ``pix``, MARCH_ITER steps of the scene's minimum iq
    distance (from 3e38 down, so a scene without triangles never stops),
    stopping below MARCH_EPS (maxt = inf, :3615); the value is the step of
    the stop times 1/(MARCH_ITER-1), 32/31 where the march never stopped.
    ``htables``/``n_tri`` from ``pack_hart``; triangles in blocks of
    ``tri_chunk`` bound the [N, block] temporaries."""
    ox, oy, oz, dx, dy, dz = _camera_rays_plain(
        cam_params.tolist(), cam_mode, pix, frame, jitter_salt)
    cols = htables.reshape(n_tri, 9).unbind(1)
    t0 = torch.full_like(ox, mint)
    px, py, pz = ox + t0 * dx, oy + t0 * dy, oz + t0 * dz
    iters = torch.full_like(ox, MARCH_ITER, dtype=torch.int32)
    done = torch.zeros_like(ox, dtype=torch.bool)
    for i in range(MARCH_ITER):
        d2 = torch.full_like(ox, _BIG)
        for base in range(0, n_tri, tri_chunk):
            vs = [c[None, base:base + tri_chunk] for c in cols]
            blk = _tri_dist2(px[:, None], py[:, None], pz[:, None], *vs)
            d2 = torch.minimum(d2, torch.amin(blk, dim=1))
        dist = torch.sqrt(d2)
        stop = dist < MARCH_EPS
        iters = torch.where(~done & stop, i, iters)
        adv = ~done & ~stop
        px = torch.where(adv, px + dist * dx, px)
        py = torch.where(adv, py + dist * dy, py)
        pz = torch.where(adv, pz + dist * dz, pz)
        done = done | stop
    val = iters.to(torch.float32) * (1.0 / (MARCH_ITER - 1))
    return torch.stack([val, val, val])


def bigmesh_search_plain(tables, counts, rays, live, mint=0.0):
    """The plain version of the big-mesh kernel's search-only instance:
    ``rays`` the six f32[N] ray components, ``live`` bool[N] -> (f32[5, N]
    winner t, normal xyz, material id; int32[2, N] family, index): every
    triangle brute force, triangles last (``_search_tris_last``), as the
    culled walk finds them (``_culled_tris_rows`` :472); a lane outside
    ``live`` gets the miss winner (t 3e38, family and index -1)."""
    tri, sph, pln, _ = _unpack_fwd(tables, counts, tri_rows=True)
    w = _search_tris_last(tri, sph, pln, *rays, mint, live)
    return torch.stack(w[:5]), torch.stack(w[5:])


def bigmesh_bounce_plain(tables, counts, pix, state, frame, salt, mint=0.0,
                         collect=False):
    """The plain version of the big-mesh kernel's bounce instance: ``state``
    f32[16, N] (``STATE_FIELDS``), ``pix`` int64[N] -> the state after one
    Kajiya bounce (the search of ``bigmesh_search_plain``, then ``_shade``
    :925 with the RNG salt ``salt``).  A dead lane passes through exactly
    (:2593-2597); the standard-style tail is the caller's (:3097-3101).
    With ``collect`` (its collect instance, :2568-2570) -> (state, int32[2,
    N] hit record: family and index, -1 where the lane was dead or
    missed)."""
    tri, sph, pln, mat = _unpack_fwd(tables, counts, tri_rows=True)
    rows = state.unbind(0)
    active = rows[15] > 0.0
    winner = _search_tris_last(tri, sph, pln, *rows[:6], mint, active)
    new, _ = _shade_plain("kajiya", mat, pix, frame, salt, (*rows[:15], active),
                          winner, None, None)
    out = torch.stack([*new[:15], new[15].to(torch.float32)])
    if not collect:
        return out
    live_hit = active & (winner[5] >= 0)
    return out, torch.stack([torch.where(live_hit, winner[5], -1),
                             torch.where(live_hit, winner[6], -1)]).to(torch.int32)


def bigmesh_distance_plain(htables, n_tri, p, live, tri_chunk=None):
    """The plain version of the big-mesh Hart distance kernel: points ``p``
    f32[3, N], ``live`` bool[N] -> f32[N], sqrt of the minimum iq squared
    distance (``_tri_dist2``) over every triangle of ``htables``
    (``pack_hart``), from 3e38 down; inf on a lane outside ``live``.  The
    minimum is exact, so the order of the triangles does not matter."""
    out = torch.full_like(p[0], float("inf"))
    lanes = torch.nonzero(live).squeeze(1)
    if lanes.numel() == 0:
        return out
    px, py, pz = (c[lanes][:, None] for c in p.unbind(0))
    n = lanes.numel()
    block = tri_chunk or max(1, min(n_tri, _PLAIN_BLOCK // 4 // n))
    cols = htables.reshape(n_tri, 9).unbind(1)
    d2 = torch.full((n,), _BIG, dtype=torch.float32, device=p.device)
    for base in range(0, n_tri, block):
        vs = [c[None, base:base + block] for c in cols]
        d2 = torch.minimum(d2, torch.amin(_tri_dist2(px, py, pz, *vs), dim=1))
    out[lanes] = torch.sqrt(d2)
    return out


def bigmesh_march_plain(htables, n_tri, o, d, mint=0.0, live=None):
    """The plain version of the big-mesh Hart march: rays ``o``/``d``
    f32[3, N], ``live`` bool[N] (None: every lane) -> int32[N], the step
    at which each ray's march from o + mint d stops (the scene distance,
    ``bigmesh_distance_plain``, below MARCH_EPS), MARCH_ITER where it never
    does and on a lane outside ``live`` (``trace_hart`` :3237)."""
    p = o + mint * d
    iters = torch.full_like(p[0], MARCH_ITER, dtype=torch.int32)
    done = (torch.zeros_like(p[0], dtype=torch.bool) if live is None
            else ~live)
    for i in range(MARCH_ITER):
        dist = bigmesh_distance_plain(htables, n_tri, p, ~done)
        stop = dist < MARCH_EPS
        iters = torch.where(~done & stop, i, iters)
        adv = ~done & ~stop
        p = torch.where(adv, p + dist * d, p)
        done = done | stop
    return iters


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------


def _path_lib():
    lib = load_library("path_kernel")
    if not hasattr(lib, "_rvpt_bound"):
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.rvpt_path_trace.argtypes = [
            ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            ptr, ptr, ptr, ptr, ptr, i32, u32, u32, u32, i32, i32, i32,
            ctypes.c_float, i32, ptr, i32, ptr, ptr, ptr,
        ]
        lib.rvpt_path_trace.restype = i32
        lib.rvpt_path_stats_sum.argtypes = [ptr, ptr, i32, i32, ptr, ptr]
        lib.rvpt_path_stats_sum.restype = i32
        lib.rvpt_max_table_floats.argtypes = []
        lib.rvpt_max_table_floats.restype = i32
        lib.rvpt_row_reject.argtypes = [i32]
        lib.rvpt_row_reject.restype = i32
        lib.rvpt_stats_scan.argtypes = [ptr, i32, i32, i32, i32, ptr, i32, ptr,
                                        *[ptr] * 6, i32, ctypes.c_float, ptr, ptr,
                                        ptr, ptr]
        lib.rvpt_stats_scan.restype = i32
        lib._rvpt_bound = True
    return lib


def row_reject(integ: str) -> bool:
    """Whether K1's row form runs integrator ``integ``'s closest-hit
    searches with the t-first reject, as its library was built
    (path_kernel.cu's row_reject); B3's row form always does, and every
    occlusion search is any-hit.  Loads the library: card only."""
    return bool(_path_lib().rvpt_row_reject(INTEGS[integ]))


def _scene_lib(load, tables, counts, nodes=None):
    """Check the row-form tables (CUDA, sized by ``counts``) and, for a BVH
    form, the ``pack_bvh`` nodes; then load the kernel's library and check
    that the tables it stages fit its shared memory (all of them, or with
    ``nodes`` all but the triangles, which the walk reads from device
    memory)."""
    t, s, p, nm = counts
    check_cuda(tables, torch.float32, "tables", 17 * t + 5 * s + 5 * p + 8 * nm)
    if nodes is not None:
        _check_nodes(nodes, tables.device)
        if t == 0:
            raise ValueError("the BVH form needs triangles")
    lib = load()
    staged = tables.numel() - (17 * t if nodes is not None else 0)
    if staged > lib.rvpt_max_table_floats():
        raise ValueError(
            f"scene tables of {staged} floats exceed the kernel's "
            f"shared-memory staging ({lib.rvpt_max_table_floats()})")
    return lib


def _check_nodes(nodes, dev):
    """Raise unless ``nodes`` are ``pack_bvh``'s [M, 8] rows on ``dev``,
    16-byte aligned (the walk loads a node as two float4)."""
    check_cuda(nodes, torch.float32, "BVH nodes", device=dev)
    if nodes.dim() != 2 or nodes.shape[1] != len(NODE_FIELDS):
        raise ValueError(f"BVH nodes: need pack_bvh's [M, {len(NODE_FIELDS)}] "
                         f"rows, got {tuple(nodes.shape)}")
    if nodes.data_ptr() % 16:
        raise ValueError("BVH nodes: need a 16-byte aligned buffer")


def _tree_lib(load, tables, counts, tree):
    """``_scene_lib`` for K1 and B3: the BVH form when ``tree`` (a
    ``WalkTree``) is given, whose triangle rows must be ``pack_walk``'s for
    the tables' triangles, 16-byte aligned (the walk loads a row as four
    float4)."""
    if tree is None:
        return _scene_lib(load, tables, counts)
    if not isinstance(tree, WalkTree):
        raise TypeError(f"the BVH form takes pack_tree's WalkTree, got {type(tree)}")
    lib = _scene_lib(load, tables, counts, tree.nodes)
    check_cuda(tree.rows, torch.float32, "walk rows",
               (len(WALK_FIELDS) + 1) * counts[0], tables.device)
    if tree.rows.data_ptr() % 16:
        raise ValueError("walk rows: need a 16-byte aligned buffer")
    return lib


def _tree_ptrs(tree):
    return (None, None) if tree is None else (tree.nodes.data_ptr(),
                                              tree.rows.data_ptr())


def _ptr(x):
    return None if x is None else x.data_ptr()


def _check_camera(pix, n, cam_params, dev):
    if pix is not None:
        check_cuda(pix, torch.int64, "pixel", n, dev)
    if cam_params is None:
        raise ValueError("camera rays need cam_params")
    check_cuda(cam_params, torch.float32, "cam_params", 24, dev)


def _check_rays(pix, n, rays, cam_params, dev):
    """Check a launch's pixel ids and its rays: the six f32[n] components
    of ``rays``, or camera rays from ``cam_params`` when ``rays`` is None
    -> (the six ray pointers or Nones, the camera pointer or None)."""
    if rays is None:
        _check_camera(pix, n, cam_params, dev)
        return [None] * 6, cam_params.data_ptr()
    if pix is not None:
        check_cuda(pix, torch.int64, "pixel", n, dev)
    if len(rays) != 6:
        raise ValueError(f"rays: need six components, got {len(rays)}")
    for k, r in enumerate(rays):
        check_cuda(r, torch.float32, f"ray component {k}", n, dev)
    return [r.data_ptr() for r in rays], None


def stats_slots(max_bounces, integ) -> int:
    """Searches per lane a launch may run, one counter slot each: a bounce
    search per bounce, Whitted's shadow search per bounce, Cook's tail."""
    nb = int(max_bounces)
    return {"kajiya": nb, "whitted": 2 * nb, "cook": nb + 1}[integ]


def _launch_path(tables, counts, pix, n, frame, salt_base, max_bounces, style,
                 rays, cam_params, cam_mode, jitter_salt, mint, collect,
                 integ, tree, cull):
    """One launch of K1 -> (f32[3, n], ``PathRecord``, int32[B, 2, n]
    hits (``collect="hits"``) or None, f32[3, ceil(n / CULL_TILE)] or
    None); ``cull`` (``cull_rows``, needs ``tree``) selects the counting
    instance and its summing kernel."""
    if integ not in INTEGS:
        raise ValueError(f"unknown integrator {integ!r}")
    if integ != "kajiya" and collect:
        raise ValueError("hit records are a Kajiya-only path")
    if collect not in (False, True, "hits"):
        raise ValueError(f"collect must be False, True or 'hits', got {collect!r}")
    if collect == "hits" and cull is not None:
        raise ValueError("the stats counters take the full record, not hits only")
    t, s, p, nm = counts
    dev = tables.device
    lib = _tree_lib(_path_lib, tables, counts, tree)
    ray_ptrs, cam_ptr = _check_rays(pix, n, rays, cam_params, dev)
    nb = int(max_bounces)
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    record = None
    if collect:
        hits = torch.empty((nb, 2, n), dtype=torch.int32, device=dev)
        record = hits if collect == "hits" else PathRecord(
            torch.empty((nb, len(RECORD_FIELDS), n), dtype=torch.float32, device=dev),
            hits)
    n_clu, masks = 0, (None, None)
    if cull is not None:
        if tree is None:
            raise ValueError("the stats counters need the BVH form")
        n_clu = cull.shape[0] - 1
        check_cuda(cull, torch.float32, "cluster boxes", 8 * (n_clu + 1), dev)
        if cull.data_ptr() % 16:
            raise ValueError("cluster boxes: need a 16-byte aligned buffer")
        if not 0 < n_clu <= CULL_MAX_TRIS // CULL_K:
            raise ValueError(f"{n_clu} clusters: the culled form takes 1.."
                             f"{CULL_MAX_TRIS // CULL_K}")
        grid, words = -(-n // CULL_TILE), -(-n_clu // 32)
        shape = (grid, stats_slots(nb, integ), words)
        masks = (torch.zeros(shape, dtype=torch.int32, device=dev),
                 torch.zeros(shape, dtype=torch.int32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rvpt_path_trace(
        tables.data_ptr(), t, s, p, nm, *_tree_ptrs(tree), cam_ptr,
        _ptr(pix), *ray_ptrs, out.data_ptr(),
        record.fields.data_ptr() if isinstance(record, PathRecord) else None,
        None if record is None else hits.data_ptr(), n,
        int(frame) & 0xFFFFFFFF, int(salt_base) & 0xFFFFFFFF,
        int(jitter_salt) & 0xFFFFFFFF, nb,
        int(style == "standard"), int(cam_mode), float(mint), INTEGS[integ],
        stream, n_clu, _ptr(cull), _ptr(masks[0]), _ptr(masks[1]))
    check_launch(lib, err, "path kernel")
    if cull is None:
        return out, record, None
    agg = torch.empty((3, grid), dtype=torch.float32, device=dev)
    err = lib.rvpt_path_stats_sum(masks[0].data_ptr(), masks[1].data_ptr(), grid,
                                  shape[1] * words, agg.data_ptr(), stream)
    check_launch(lib, err, "path stats sum")
    return out, record, agg


def launch_path_kernel(tables, counts, pix, n, frame, salt_base, max_bounces,
                       style, rays=None, cam_params=None, cam_mode=PINHOLE,
                       jitter_salt=0, mint=0.0, collect=False, integ="kajiya",
                       tree=None):
    """Launch the CUDA kernel -> f32[3, n] on the tables' card, or
    (f32[3, n], ``PathRecord``) with ``collect``, or (f32[3, n], int32[B,
    2, n] hits) with ``collect="hits"`` (the hits-only collect instance).

    ``pix`` int64[n] pixel ids, or None for the ids 0..n-1 (the raster
    film).  ``tree`` (``pack_tree``) selects the BVH form, which walks the
    tree for the triangles after the spheres and planes
    (``trace_plain(tris_last=True)``); None the row form.  Other arguments
    as ``trace_plain``.  Counts one launch in
    ``launch_path_kernel.launches``."""
    out, record, _ = _launch_path(
        tables, counts, pix, n, frame, salt_base, max_bounces, style, rays,
        cam_params, cam_mode, jitter_salt, mint, collect, integ, tree, None)
    launch_path_kernel.launches += 1
    return out if record is None else (out, record)


def launch_path_stats(tables, counts, tree, cull, pix, n, frame, salt_base,
                      max_bounces, style, rays=None, cam_params=None,
                      cam_mode=PINHOLE, jitter_salt=0, mint=0.0, collect=False,
                      integ="kajiya"):
    """K1's BVH form with the culled walk's counters (the ``stats`` form of
    ``make_path_kernel`` :1116): its counting instance, whose lanes set the
    bits of the clusters they list and still pass in per (tile, search)
    masks after each search, then a kernel that counts the bits ->
    (f32[3, n], f32[3, ceil(n / CULL_TILE)]), or with ``collect`` (f32[3,
    n], ``PathRecord``, counters).  ``tree`` is ``pack_tree``'s, ``cull``
    ``cull_rows``; the radiance and records are those of
    ``launch_path_kernel``, bit for bit.  Counts one launch (the pair) in
    ``launch_path_stats.launches``."""
    out, record, agg = _launch_path(
        tables, counts, pix, n, frame, salt_base, max_bounces, style, rays,
        cam_params, cam_mode, jitter_salt, mint, collect, integ, tree, cull)
    launch_path_stats.launches += 1
    return (out, agg) if record is None else (out, record, agg)


launch_path_stats.launches = 0


def stats_scan(tables, counts, tree, cull, rays, mint=0.0):
    """The counting instances' cluster scan checked on the card against the
    parent's: for each ray (six f32[N], rays passed in) the sphere/plane
    winner's t, then every cluster of ``cull`` (``cull_rows``) in id order,
    by the t-only test on ``tree``'s rows and by the full triangle test
    (``bvh::test_triangle``) on ``pack_fwd``'s -> (t f32[N] of each scan,
    int32[N] clusters after which they differ: 0 where the two agree).  A
    check, on no path; counts its launches in ``stats_scan.launches``."""
    t, s, p, nm = counts
    dev = tables.device
    lib = _tree_lib(_path_lib, tables, counts, tree)
    n = rays[0].numel()
    for k, c in enumerate(rays):
        check_cuda(c, torch.float32, f"ray component {k}", n, dev)
    n_clu = cull.shape[0] - 1
    check_cuda(cull, torch.float32, "cluster boxes", 8 * (n_clu + 1), dev)
    t_ref = torch.empty((n,), dtype=torch.float32, device=dev)
    t_new = torch.empty_like(t_ref)
    differ = torch.empty((n,), dtype=torch.int32, device=dev)
    err = lib.rvpt_stats_scan(
        tables.data_ptr(), t, s, p, nm, tree.rows.data_ptr(), n_clu,
        cull.data_ptr(), *(c.data_ptr() for c in rays), n, float(mint),
        t_ref.data_ptr(), t_new.data_ptr(), differ.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, err, "stats scan")
    stats_scan.launches += 1
    return t_ref, t_new, differ


stats_scan.launches = 0
launch_path_kernel.launches = 0


def _primary_lib():
    lib = load_library("primary_kernel")
    if not hasattr(lib, "_rvpt_bound"):
        ptr, i32, u32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
        lib.rvpt_primary.argtypes = [ptr, i32, i32, i32, i32, ptr, ptr, ptr,
                                     ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                     ptr, i32, u32, u32, u32, i32, i32, f32,
                                     i32, f32, ptr]
        lib.rvpt_primary.restype = i32
        lib.rvpt_walk_count.argtypes = [ptr, i32, i32, i32, i32, ptr, ptr, ptr,
                                        ptr, i32, i32, f32, ptr]
        lib.rvpt_walk_count.restype = i32
        lib.rvpt_max_table_floats.argtypes = []
        lib.rvpt_max_table_floats.restype = i32
        lib._rvpt_bound = True
    return lib


def launch_primary_kernel(tables, counts, pix, n, frame, salt_base, mode,
                          nrays, cam_params, cam_mode=PINHOLE, jitter_salt=0,
                          mint=0.0, tree=None, rays=None):
    """Launch the CUDA primary-hit kernel B3 -> f32[3, n] on the tables'
    card.  ``pix`` int64[n] pixel ids, or None for the ids 0..n-1;
    ``tree`` (``pack_tree``) selects the BVH form; ``rays`` (six
    contiguous f32[n] components) its rays-in form, which needs no
    ``cam_params``.
    Other arguments as ``primary_plain``.  Counts one launch in
    ``launch_primary_kernel.launches``."""
    if mode not in PRIMARY_MODES:
        raise ValueError(f"mode {mode} is not a primary-hit mode")
    nrays = int(nrays)
    if nrays < 1:
        raise ValueError(f"nrays must be at least 1, got {nrays}")
    t, s, p, nm = counts
    dev = tables.device
    lib = _tree_lib(_primary_lib, tables, counts, tree)
    ray_ptrs, cam_ptr = _check_rays(pix, n, rays, cam_params, dev)
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    err = lib.rvpt_primary(
        tables.data_ptr(), t, s, p, nm, *_tree_ptrs(tree), cam_ptr,
        _ptr(pix), *ray_ptrs, out.data_ptr(), n,
        int(frame) & 0xFFFFFFFF, int(salt_base) & 0xFFFFFFFF,
        int(jitter_salt) & 0xFFFFFFFF, int(mode), int(cam_mode), float(mint),
        nrays, _f32(1.0 / nrays), torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, err, "primary-hit kernel")
    launch_primary_kernel.launches += 1
    return out


launch_primary_kernel.launches = 0


def _hart_lib():
    lib = load_library("hart_kernel")
    if not hasattr(lib, "_rvpt_bound"):
        ptr, i32, u32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
        lib.rvpt_hart.argtypes = [ptr, i32, ptr, ptr, ptr, i32, u32, u32, i32,
                                  f32, ptr]
        lib.rvpt_hart.restype = i32
        lib.rvpt_hart_count.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, i32, u32,
                                        u32, i32, f32, ptr]
        lib.rvpt_hart_count.restype = i32
        lib._rvpt_bound = True
    return lib


# The rows of B4's counting instance: the march's own live ray-steps, skip
# tests, full distances on the face and the edge branch and warm seeds (up
# to each ray's stop or escape); skipped triangles whose distance is below
# the running minimum; the branch of every triangle's distance at every
# step the parent ran (marching on past the escape), and those steps; the
# rays that stopped after their escape; and the march's own tests that the
# plane decided (the rest also test the bounding sphere).
HART_COUNTS = ("steps", "tests", "face", "edge", "seeds", "bad", "all_face",
               "all_edge", "parent_steps", "late", "plane_skips")


def _run_hart(htables, n_tri, pix, n, frame, cam_params, cam_mode, jitter_salt,
              mint, count=False):
    """One launch of the Hart march kernel, or (with ``count``) of its
    counting instance -> (f32[3, n], int32[len(HART_COUNTS), n] or None)."""
    dev = htables.device
    check_cuda(htables, torch.float32, "Hart tables", 9 * n_tri)
    _check_camera(pix, n, cam_params, dev)
    lib = _hart_lib()
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    args = (htables.data_ptr() if n_tri else None, n_tri, cam_params.data_ptr(),
            None if pix is None else pix.data_ptr(), out.data_ptr())
    tail = (n, int(frame) & 0xFFFFFFFF, int(jitter_salt) & 0xFFFFFFFF,
            int(cam_mode), float(mint), torch.cuda.current_stream(dev).cuda_stream)
    if count:
        out_c = torch.zeros((len(HART_COUNTS), n), dtype=torch.int32, device=dev)
        err = lib.rvpt_hart_count(*args, out_c.data_ptr(), *tail)
    else:
        out_c = None
        err = lib.rvpt_hart(*args, *tail)
    check_launch(lib, err, "Hart kernel")
    return out, out_c


def launch_hart_kernel(htables, n_tri, pix, n, frame, cam_params,
                       cam_mode=PINHOLE, jitter_salt=0, mint=0.0):
    """Launch the CUDA Hart march kernel B4 -> f32[3, n] on the tables'
    card.  ``htables``/``n_tri`` from ``pack_hart`` (zero triangles
    allowed); ``pix`` int64[n] pixel ids, or None for the ids 0..n-1.
    Counts one launch in ``launch_hart_kernel.launches``."""
    out, _ = _run_hart(htables, n_tri, pix, n, frame, cam_params, cam_mode,
                       jitter_salt, mint)
    launch_hart_kernel.launches += 1
    return out


def count_hart_sweep(htables, n_tri, pix, n, frame, cam_params,
                     cam_mode=PINHOLE, jitter_salt=0, mint=0.0):
    """B4's work on the card, for a bound: its counting instance, with the
    arguments of ``launch_hart_kernel`` -> (f32[3, n] as that launch's, a
    dict of the ``HART_COUNTS`` summed over the pixels).  Adds no launch of
    B4."""
    out, c = _run_hart(htables, n_tri, pix, n, frame, cam_params, cam_mode,
                       jitter_salt, mint, count=True)
    return out, dict(zip(HART_COUNTS, c.sum(dim=1, dtype=torch.int64).tolist()))


launch_hart_kernel.launches = 0


def _bigmesh_lib():
    lib = load_library("bigmesh_kernel")
    if not hasattr(lib, "_rvpt_bound"):
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.rvpt_bigmesh.argtypes = [ptr, i32, i32, i32, i32, ptr, ptr, ptr,
                                     i32, ptr, ptr, ptr, ptr, ptr, i32, u32,
                                     u32, ctypes.c_float, ptr]
        lib.rvpt_bigmesh.restype = i32
        lib.rvpt_max_table_floats.argtypes = []
        lib.rvpt_max_table_floats.restype = i32
        lib._rvpt_bound = True
    return lib


def _run_bigmesh(tables, counts, nodes, pix, state, frame, salt, mint,
                 search_only, count=False, collect=False):
    """One launch of the big-mesh kernel's bounce, (with ``collect``)
    collect, search-only or (with ``count``) counting instance -> out_state,
    (out_state, out_hits), or (out_w, out_i, out_count or None)."""
    rows = 7 if search_only else len(STATE_FIELDS)
    t, s, p, nm = counts
    dev = tables.device
    lib = _scene_lib(_bigmesh_lib, tables, counts, nodes)
    if state.dim() != 2 or state.shape[0] != rows:
        raise ValueError(f"state: need [{rows}, N], got {tuple(state.shape)}")
    n = state.shape[1]
    check_cuda(state, torch.float32, "state", device=dev)
    if not search_only:
        check_cuda(pix, torch.int64, "pixel", n, dev)
    out_state = out_w = out_i = out_c = out_h = None
    if search_only:
        out_w = torch.empty((5, n), dtype=torch.float32, device=dev)
        out_i = torch.empty((2, n), dtype=torch.int32, device=dev)
        if count:
            out_c = torch.empty((3, n), dtype=torch.int32, device=dev)
    else:
        out_state = torch.empty_like(state)
        if collect:
            out_h = torch.empty((2, n), dtype=torch.int32, device=dev)
    err = lib.rvpt_bigmesh(
        tables.data_ptr(), t, s, p, nm, nodes.data_ptr(),
        None if search_only else pix.data_ptr(), state.data_ptr(), rows - 1,
        _ptr(out_state), _ptr(out_w), _ptr(out_i), _ptr(out_c), _ptr(out_h), n,
        int(frame) & 0xFFFFFFFF, int(salt) & 0xFFFFFFFF, float(mint),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, err, "big-mesh kernel")
    if search_only:
        return out_w, out_i, out_c
    return (out_state, out_h) if collect else out_state


def launch_bigmesh_kernel(tables, counts, nodes, pix, state, frame, salt,
                          mint=0.0, search_only=False, collect=False):
    """Launch the CUDA big-mesh kernel B5 on the tables' card: per ray the
    BVH search (spheres and planes, then the triangles by the tree), then
    one Kajiya bounce.

    ``state`` is f32[16, N] (``STATE_FIELDS``) and the result the state
    after the bounce, as ``bigmesh_bounce_plain``; ``pix`` int64[N]; with
    ``collect`` (the collect instance) the result is (state, int32[2, N]
    hit record), as ``bigmesh_bounce_plain(collect=True)``.  With
    ``search_only`` ``state`` is f32[7, N] (the ray, then live as 0/1),
    ``pix`` is unused and the result the winner of
    ``bigmesh_search_plain``.  Counts one launch in
    ``launch_bigmesh_kernel.launches``."""
    out = _run_bigmesh(tables, counts, nodes, pix, state, frame, salt, mint,
                       search_only, collect=collect)
    launch_bigmesh_kernel.launches += 1
    return out[:2] if search_only else out


def count_bvh_walk(tables, counts, nodes, rays, live, mint=0.0, lanes=False):
    """The binary BVH walk's work on the card, for a bound: the big-mesh
    kernel's counting instance (its search-only walk of ``bvh_search.cuh``,
    B5's, with COUNT; the work K1's and B3's walk did before its redesign)
    on ``rays`` (six f32[N]) where ``live`` (bool[N]) -> (node slab tests,
    the root's included; triangle tests), summed over the lanes; with
    ``lanes`` the int32[3, N] counts per lane (node tests, triangle tests,
    loop iterations; 0 where not live).  It serves the bounds of
    chip_smoke.py, not a display path, so it adds no launch of B5."""
    state = torch.stack([*rays, live.to(torch.float32)]).contiguous()
    _, _, c = _run_bigmesh(tables, counts, nodes, None, state, 0, 0, mint,
                           True, count=True)
    if lanes:
        return c
    box, tri = c[:2].sum(dim=1, dtype=torch.int64).tolist()
    return box, tri


def count_walk(tables, counts, tree, rays, live, any_hit=False, mint=0.0):
    """The work of K1's and B3's BVH walk (``bvh_walk.cuh``) on the card:
    its counting instance (``primary_kernel.cu``'s ``walk_count_kernel``)
    runs one closest-hit search, or with ``any_hit`` one occlusion search
    (spheres and planes, then the walk to the first hit), per lane of
    ``rays`` (six f32[N]) where ``live`` (bool[N]) on ``tree``
    (``pack_tree``) -> int32[4, N]: node slab tests, triangle rows opened
    (first float4 and t), rows tested in full after the t-first reject,
    loop iterations; 0 where not live.  For chip_smoke.py's census and
    bounds; it adds no launch of B3."""
    t, s, p, nm = counts
    dev = tables.device
    if tree is None:
        raise ValueError("count_walk needs pack_tree's tree")
    lib = _tree_lib(_primary_lib, tables, counts, tree)
    state = torch.stack([*rays, live.to(torch.float32)]).contiguous()
    n = state.shape[1]
    out = torch.empty((4, n), dtype=torch.int32, device=dev)
    err = lib.rvpt_walk_count(
        tables.data_ptr(), t, s, p, nm, *_tree_ptrs(tree), state.data_ptr(), out.data_ptr(), n, int(bool(any_hit)), float(mint),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, err, "walk counting kernel")
    return out


launch_bigmesh_kernel.launches = 0


def _bigmesh_hart_lib():
    lib = load_library("bigmesh_hart")
    if not hasattr(lib, "_rvpt_bound"):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rvpt_bigmesh_hart.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, ptr,
                                          i32, ptr]
        lib.rvpt_bigmesh_hart.restype = i32
        lib.rvpt_bigmesh_march.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, f32,
                                           f32, f32, f32, f32, ptr, ptr, i32,
                                           ptr]
        lib.rvpt_bigmesh_march.restype = i32
        lib._rvpt_bound = True
    return lib


def _check_hart(htables, n_tri, nodes, p, what):
    dev = htables.device
    check_cuda(htables, torch.float32, "Hart tables", 9 * n_tri)
    _check_nodes(nodes, dev)
    if p.dim() != 2 or p.shape[0] != 3:
        raise ValueError(f"{what}: need [3, N], got {tuple(p.shape)}")
    check_cuda(p, torch.float32, what, device=dev)
    if n_tri == 0:
        raise ValueError("the big-mesh Hart kernel needs triangles")


def _run_bigmesh_hart(htables, n_tri, nodes, p, live, count=False):
    """One launch of the big-mesh Hart kernel, or (with ``count``) of its
    counting instance -> (f32[N], int32[2, N] or None)."""
    _check_hart(htables, n_tri, nodes, p, "points")
    dev, n = htables.device, p.shape[1]
    check_cuda(live, torch.float32, "live", n, dev)
    lib = _bigmesh_hart_lib()
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    out_c = torch.empty((2, n), dtype=torch.int32, device=dev) if count else None
    err = lib.rvpt_bigmesh_hart(
        htables.data_ptr(), nodes.data_ptr(), n_tri, p.data_ptr(),
        live.data_ptr(), out.data_ptr(), _ptr(out_c), n,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, err, "big-mesh Hart kernel")
    return out, out_c


def launch_bigmesh_hart(htables, n_tri, nodes, p, live):
    """Launch the CUDA big-mesh Hart distance kernel B6 on the tables' card:
    points ``p`` f32[3, N], ``live`` f32[N] (0/1) -> f32[N] as
    ``bigmesh_distance_plain``.  Counts one launch in
    ``launch_bigmesh_hart.launches``."""
    out, _ = _run_bigmesh_hart(htables, n_tri, nodes, p, live)
    launch_bigmesh_hart.launches += 1
    return out


# Margin of the march's escape ball over the mesh's bound: ten times
# MARCH_EPS, far above any rounding of a distance.
ESCAPE_MARGIN = 1.0


def march_escape(nodes: torch.Tensor) -> tuple[float, float, float, float]:
    """The escape ball of B6's march: the centre (x, y, z) of the padded
    root box of ``nodes`` (``pack_bvh``) and the squared radius of the ball
    around it grown by ``ESCAPE_MARGIN`` and by the f32 rounding of the
    centre, computed in float64 on the host."""
    lo, hi = nodes[0, :3].double().cpu(), nodes[0, 3:6].double().cpu()
    c = (lo + hi) / 2
    r = float(torch.linalg.vector_norm(hi - lo)) / 2
    r += ESCAPE_MARGIN + 1e-6 * (float(c.abs().max()) + r)
    return (*c.tolist(), r * r)


def _run_bigmesh_march(htables, n_tri, nodes, o, d, mint, live, escape,
                       count=False):
    """One launch of the big-mesh Hart march, or (with ``count``) of its
    counting instance -> (int32[N], int32[7, N] or None)."""
    _check_hart(htables, n_tri, nodes, o, "origins")
    dev, n = htables.device, o.shape[1]
    check_cuda(d, torch.float32, "directions", 3 * n, dev)
    if live is not None:
        check_cuda(live, torch.float32, "live", n, dev)
    if escape is None:
        escape = march_escape(nodes)
    lib = _bigmesh_hart_lib()
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    out_c = torch.empty((7, n), dtype=torch.int32, device=dev) if count else None
    err = lib.rvpt_bigmesh_march(
        htables.data_ptr(), nodes.data_ptr(), n_tri, o.data_ptr(), d.data_ptr(),
        _ptr(live), float(mint), *escape, out.data_ptr(), _ptr(out_c), n,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, err, "big-mesh Hart march")
    return out, out_c


def launch_bigmesh_march(htables, n_tri, nodes, o, d, mint=0.0, live=None,
                         escape=None):
    """Launch the CUDA big-mesh Hart march (B6's march instance) on the
    tables' card: rays ``o``/``d`` f32[3, N], ``live`` f32[N] (0/1) or None
    -> int32[N] as ``bigmesh_march_plain``, the whole march in one launch.
    ``escape`` is ``march_escape(nodes)`` (computed here when None, which
    reads the root box back to the host).  Counts one launch in
    ``launch_bigmesh_march.launches`` (none for no rays, which launch
    nothing)."""
    out, _ = _run_bigmesh_march(htables, n_tri, nodes, o, d, mint, live, escape)
    if out.numel():
        launch_bigmesh_march.launches += 1
    return out


launch_bigmesh_march.launches = 0


def count_hart_march(htables, n_tri, nodes, o, d, mint=0.0, live=None):
    """The march's walks' work on the card, for a bound: its counting
    instance on rays ``o``/``d`` f32[3, N] -> (steps, a dict of the
    warm-started walk's node box and triangle distances up to the escape
    (the march's own work) and its walks (the steps at which it walked),
    the cold-start walk's at every step the per-step design ran (marching
    on past the escape: the parent's work), the steps whose two minima
    differ, and the rays that stopped after their escape (0 unless the
    escape test fails)), summed over the rays; ``steps`` int32[N] as
    ``launch_bigmesh_march``'s.  Adds no launch of the march."""
    steps, c = _run_bigmesh_march(htables, n_tri, nodes, o.contiguous(),
                                  d.contiguous(), mint, live, None, count=True)
    cb, ct, wb, wt, differ, late, walks = c.sum(dim=1, dtype=torch.int64).tolist()
    return steps, {"warm_box": wb, "warm_tri": wt, "walks": walks,
                   "cold_box": cb, "cold_tri": ct, "differ": differ, "late": late}


def count_hart_walk(htables, n_tri, nodes, p, live):
    """B6's per-step walk's work on the card, for a bound: its counting
    instance on points ``p`` f32[3, N] where ``live`` (bool[N]) -> (node
    box distances, the root's included; triangle distances), summed over
    the points.  Adds no launch of B6."""
    _, c = _run_bigmesh_hart(htables, n_tri, nodes, p.contiguous(),
                             live.to(torch.float32).contiguous(), count=True)
    box, tri = c.sum(dim=1, dtype=torch.int64).tolist()
    return box, tri


launch_bigmesh_hart.launches = 0


def _pixels(pixel):
    """(n, pixel ids or None) of a ``pixel`` argument: an int64[N] tensor,
    or an int N meaning the raster ids 0..N-1."""
    if isinstance(pixel, int):
        return pixel, None
    return pixel.shape[0], pixel


def _raster(pix, n, dev):
    return torch.arange(n, dtype=torch.int64, device=dev) if pix is None else pix


# True inside ``utils.debug.interpret_kernels``: the tracers run their
# plain versions on the card too.
PLAIN_KERNELS = contextvars.ContextVar("rvpt_plain_kernels", default=False)


def _on_device(dev, kernel, plain):
    """Run ``kernel`` for tables on the card and ``plain`` for tables on
    the CPU (or on the card inside ``interpret_kernels``); no other device
    and no fallback."""
    if dev.type == "cuda":
        return plain() if PLAIN_KERNELS.get() else kernel()
    if dev.type == "cpu":
        return plain()
    raise ValueError(f"no tracer for device {dev}")


class PathTracer(nn.Module):
    """Whole-path, primary-hit and Hart tracer for one scene: the packed
    search tables and the Hart vertex rows live as buffers on the scene's
    device.  Each entry runs its CUDA kernel for a scene on the card and
    its plain version for a scene on the CPU.

    A BVH scene of any size takes K1's and B3's BVH form, the port of
    their culled form (``meta["culled"]`` :828-835): ``pack_tree``'s nodes
    and triangle rows are buffers too (``tree``), and the search walks the
    tree for the triangles after the spheres and planes.
    (``render.make_tracer`` sends a big mesh, ``is_bigmesh``, to its
    subclass ``BigMeshTracer``, which takes the rays from the caller.)  A scene that
    JAX's tracer culls (``is_culled``: 1 to CULL_MAX_TRIS triangles) also
    keeps the ``cull_rows`` boxes, for ``trace(stats=True)``.  Hart runs B4
    on the raw vertex rows either way."""

    def __init__(self, scene: Scene, mint: float = 0.0):
        super().__init__()
        tables, self.counts = pack_fwd(scene)
        self.register_buffer("tables", tables)
        self.bvh_form = scene.bvh is not None and scene.num_triangles > 0
        tree = pack_tree(scene, tables, self.counts) if self.bvh_form else None
        self.register_buffer("nodes", None if tree is None else tree.nodes)
        self.register_buffer("walk", None if tree is None else tree.rows)
        self.register_buffer(
            "cull", cull_rows(pack_cull(scene)) if is_culled(scene) else None)
        htables, self.hart_count = pack_hart(scene)
        self.register_buffer("hart_tables", htables)
        self.mint = float(mint)

    @property
    def tree(self):
        """The ``WalkTree`` of K1's and B3's BVH form, or None (row form)."""
        return WalkTree(self.nodes, self.walk) if self.bvh_form else None

    def trace(self, pixel, origin, direction, frame, salt_base, max_bounces,
              style="reference", gen_rays=False, cam_params=None,
              cam_mode=PINHOLE, jitter_salt=0, collect_states=False,
              integ="kajiya", stats=False, collect_hits=False):
        """Trace full paths -> (r, g, b), each f32[N] (the JAX
        ``PathTracer.trace`` interface), or ((r, g, b), ``PathRecord``)
        with ``collect_states``, or ((r, g, b), (fams, idxs)) with
        ``collect_hits``: the per-bounce hits int64[B, N] of K1's hits-only
        collect instance, the layout of ``hits_from_record``; ``forward``
        returns the radiance as one f32[3, N] tensor.

        ``pixel`` is an int64[N] tensor of pixel ids, or an int N meaning
        the raster ids 0..N-1.  With ``gen_rays`` the camera rays are made
        inside the trace from ``cam_params`` (``camera_params``) and
        ``origin``/``direction`` are ignored; otherwise they are f32[N,3]
        tensors or (x, y, z) tuples of f32[N].  ``integ`` selects the
        bounce integrator (kajiya/whitted/cook); records are Kajiya-only.

        ``stats`` (:1706-1764) adds the culled walk's counters, summed over
        every search of the trace: ((r, g, b), (listed, processed, still
        passed)), or with ``collect_states`` ((r, g, b), record, counters),
        each counter f32[ceil(N / CULL_TILE)], one per tile of CULL_TILE
        consecutive rays.  A scene JAX does not cull returns zeros.  JAX
        pads the last tile with lanes that start live (:1188) and counts
        them; the port counts only the N real lanes, so the two agree on
        tiles of real rays (N a multiple of CULL_TILE)."""
        out = self(pixel, origin, direction, frame, salt_base, max_bounces,
                   style, gen_rays, cam_params, cam_mode, jitter_salt,
                   collect_states, integ, stats, collect_hits)
        if collect_hits:
            return out[0].unbind(0), _hits_pair(out[1])
        if not stats:
            return (out[0].unbind(0), out[1]) if collect_states else out.unbind(0)
        agg = tuple(out[-1].unbind(0))
        if collect_states:
            return out[0].unbind(0), out[1], agg
        return out[0].unbind(0), agg

    def forward(self, pixel, origin, direction, frame, salt_base, max_bounces,
                style="reference", gen_rays=False, cam_params=None,
                cam_mode=PINHOLE, jitter_salt=0, collect_states=False,
                integ="kajiya", stats=False, collect_hits=False):
        if collect_hits and (collect_states or stats):
            raise ValueError("collect_hits takes neither collect_states nor stats")
        n, pix = _pixels(pixel)
        rays = None if gen_rays else self._rays(origin, direction)
        kw = dict(rays=rays, cam_params=cam_params, cam_mode=cam_mode,
                  jitter_salt=jitter_salt, mint=self.mint,
                  collect="hits" if collect_hits else collect_states,
                  integ=integ)
        counted = stats and self.cull is not None

        def kernel():
            if counted:
                return launch_path_stats(self.tables, self.counts, self.tree,
                                         self.cull, pix, n, frame, salt_base,
                                         max_bounces, style, **kw)
            return launch_path_kernel(self.tables, self.counts, pix, n, frame,
                                      salt_base, max_bounces, style,
                                      tree=self.tree, **kw)

        def plain():
            acc = hook = None
            if counted:
                acc = torch.zeros((3, -(-n // CULL_TILE)), dtype=torch.float32,
                                  device=self.tables.device)
                hook = cull_stats_hook(self.tables, self.counts, self.cull, n,
                                       acc, self.mint)
            out = trace_plain(self.tables, self.counts,
                              _raster(pix, n, self.tables.device),
                              frame, salt_base, max_bounces, style,
                              tris_last=self.bvh_form, on_search=hook, **kw)
            return out if acc is None else (
                (*out, acc) if collect_states else (out, acc))

        out = _on_device(self.tables.device, kernel, plain)
        if stats and not counted:
            zeros = torch.zeros((3, -(-n // CULL_TILE)), dtype=torch.float32,
                                device=self.tables.device)
            out = (*out, zeros) if collect_states else (out, zeros)
        return out

    def trace_primary(self, pixel, frame, mode, *, salt_base, nrays=1,
                      cam_params=None, cam_mode=PINHOLE, jitter_salt=0,
                      rays=None):
        """Single-intersection debug integrator ``mode`` (``PRIMARY_MODES``)
        -> f32[3, N], which unpacks as the (r, g, b) of the JAX
        ``trace_primary`` (:1773): camera rays made in the trace from
        ``cam_params``, or the six f32[N] components ``rays`` (B3's rays-in
        form).  ``pixel`` as for ``trace``."""
        n, pix = _pixels(pixel)
        return _on_device(
            self.tables.device,
            lambda: launch_primary_kernel(
                self.tables, self.counts, pix, n, frame, salt_base, mode,
                nrays, cam_params, cam_mode, jitter_salt, self.mint,
                self.tree, rays=rays),
            lambda: primary_plain(
                self.tables, self.counts, _raster(pix, n, self.tables.device), frame,
                salt_base, mode, nrays, cam_params, cam_mode, jitter_salt,
                self.mint, tris_last=self.bvh_form, rays=rays))

    def trace_hart(self, pixel, frame, *, cam_params, cam_mode, jitter_salt):
        """Hart heat map with camera rays made in the trace -> f32[3, N],
        which unpacks as the (r, g, b) of the JAX ``trace_hart`` (:3653),
        from the cached vertex rows.  ``pixel`` as for ``trace``."""
        n, pix = _pixels(pixel)
        return _on_device(
            self.hart_tables.device,
            lambda: launch_hart_kernel(
                self.hart_tables, self.hart_count, pix, n, frame, cam_params,
                cam_mode, jitter_salt, self.mint),
            lambda: hart_plain(
                self.hart_tables, self.hart_count, _raster(pix, n, self.tables.device),
                frame, cam_params, cam_mode, jitter_salt, self.mint))

    @staticmethod
    def _rays(origin, direction):
        """The six contiguous f32[N] ray components of f32[N, 3] origins and
        directions, or of (x, y, z) tuples of f32[N]."""
        if isinstance(origin, tuple):
            return tuple(c.contiguous() for c in (*origin, *direction))
        o, d = origin.T.contiguous(), direction.T.contiguous()
        return (*o.unbind(0), *d.unbind(0))

    @staticmethod
    def hits_from_record(record: PathRecord):
        """Per-bounce (families, indices) int64[B, N] of a record (the
        JAX ``hits_from_record`` layout)."""
        return _hits_pair(record.hits)


def _hits_pair(hits):
    """(families, indices) int64[B, N] of int32[B, 2, N] hit records."""
    return hits[:, 0].long(), hits[:, 1].long()


class BigMeshTracer(PathTracer):
    """Tracer for a BVH mesh of more than min(BIG_ROUTE_TRIS, CULL_MAX_TRIS)
    triangles (``BigMeshTracer`` :2927), every integrator mode, with the
    JAX tracer's interface: rays arrive from the caller (``render.py``
    makes them with ``jittered_camera_rays``, as the JAX path does).  The
    tables, nodes and Hart vertex rows are ``PathTracer``'s, and so is the
    launch:

    * ``trace`` (Kajiya) and ``trace_shaded`` (Whitted, Cook): one launch
      of K1's BVH form with the rays passed in, the whole path in the
      kernel (``trace_plain(tris_last=True, rays=...)`` on the CPU);
    * ``trace_primary`` (modes 0-6): one launch of B3's BVH form with the
      rays passed in (``primary_plain(tris_last=True, rays=...)``);
    * ``trace_hart``: the whole 32-step march in one launch of B6's march
      instance; ``distance`` is one step's scene distance (B6's per-step
      instance).

    The JAX tracer runs a big mesh one launch per bounce or search (its
    chunk DMAs need it), with the state or the shading between launches.
    Those per-bounce pieces stay here as B5's entry points, ``bounce``
    (one Kajiya bounce of a state f32[16, N]) and ``search`` (a closest
    hit), and their plain versions; composed bounce by bounce
    (``ops.bigmesh_route.per_bounce``) they give the results of the
    one-launch route bit for bit.  On a scene on the CPU every launch is
    its plain version.  Not ported: the TPU kernels' chunk streams, work
    lists and wavefront sorts, which never change a ray's result (a cull
    or prune never changes the winner, :2940-2943)."""

    def __init__(self, scene: Scene, mint: float = 0.0):
        if scene.bvh is None or scene.num_triangles == 0:
            raise ValueError("BigMeshTracer needs a BVH-attached scene "
                             "(leaf-ordered triangles)")
        super().__init__(scene, mint)
        self._escape = None

    @property
    def escape(self):
        """B6's escape ball (``march_escape``), read back from the nodes at
        the first Hart frame only: the other routes never need it."""
        if self._escape is None:
            self._escape = march_escape(self.nodes)
        return self._escape

    @property
    def _mat(self):
        t, s, p, nm = self.counts
        return self.tables[17 * t + 5 * s + 5 * p:].reshape(nm, 8)

    def search(self, origin, direction, live=None):
        """Closest hit over the whole scene: ``origin``/``direction`` (x, y,
        z) tuples of f32[N], ``live`` bool[N] (None: every lane) -> the
        winner (t, normal xyz, material id, family, index), family -1 on a
        miss and on every lane outside ``live`` (``search_tiles`` :3122;
        B5's search-only instance)."""
        rays = tuple(origin) + tuple(direction)
        if live is None:
            live = torch.ones_like(rays[0], dtype=torch.bool)

        def kernel():
            packed = torch.stack([*rays, live.to(torch.float32)])
            w, i = launch_bigmesh_kernel(self.tables, self.counts, self.nodes,
                                         None, packed, 0, 0, self.mint,
                                         search_only=True)
            return (*w.unbind(0), *i.unbind(0))

        def plain():
            w, i = bigmesh_search_plain(self.tables, self.counts, rays, live,
                                        self.mint)
            return (*w.unbind(0), *i.unbind(0))

        return _on_device(self.tables.device, kernel, plain)

    def bounce(self, pix, state, frame, salt, collect=False):
        """One Kajiya bounce of ``state`` f32[16, N] (``STATE_FIELDS``) ->
        the new state, or with ``collect`` (state, int32[2, N] hit record)
        (B5's bounce or collect instance, or its plain version)."""
        return _on_device(
            self.tables.device,
            lambda: launch_bigmesh_kernel(self.tables, self.counts, self.nodes,
                                          pix, state, frame, salt, self.mint,
                                          collect=collect),
            lambda: bigmesh_bounce_plain(self.tables, self.counts, pix, state,
                                         frame, salt, self.mint, collect))

    def distance(self, p, live):
        """The scene's unsigned distance at points ``p`` f32[3, N] for the
        lanes of ``live`` bool[N] (B6, or its plain version); inf
        elsewhere."""
        return _on_device(
            self.tables.device,
            lambda: launch_bigmesh_hart(self.hart_tables, self.hart_count,
                                        self.nodes, p.contiguous(),
                                        live.to(torch.float32)),
            lambda: bigmesh_distance_plain(self.hart_tables, self.hart_count,
                                           p, live))

    def trace(self, pixel, origin, direction, frame, salt_base, max_bounces,
              style="reference", collect_hits=False):
        """Kajiya paths -> f32[3, N] (unpacks as the JAX ``trace``'s (r, g,
        b), :2966): ``pixel`` int64[N], ``origin``/``direction`` f32[N,3];
        bounce b draws with salt ``salt_base + 4 b``; the standard-style
        tail runs in the kernel (:3097-3101).  With ``collect_hits`` ->
        (f32[3, N], (fams, idxs)): the per-bounce hit records int64[B, N]
        of K1's hits-only collect instance (-1 where dead or missed), the
        layout of ``PathTracer.hits_from_record``."""
        out = self(pixel, origin, direction, frame, salt_base, max_bounces,
                   style, collect_hits=collect_hits)
        return (out[0], _hits_pair(out[1])) if collect_hits else out

    def trace_primary(self, pixel, origin, direction, frame, mode, *,
                      salt_base, nrays=1):
        """Debug integrator ``mode`` (``PRIMARY_MODES``) -> f32[3, N]
        (:3143): one launch of B3's BVH form on the passed-in rays, its AO
        probes (salts ``salt_base + 4 i``) and Appel shadow rays in the
        kernel."""
        return super().trace_primary(pixel, frame, mode, salt_base=salt_base,
                                     nrays=nrays, rays=self._rays(origin, direction))

    def trace_shaded(self, pixel, origin, direction, frame, integ, *,
                     salt_base, max_bounces, style="reference"):
        """Whitted or Cook paths -> f32[3, N] (:3168): one launch of K1's
        BVH form, its shadow searches (Whitted) and tail search (Cook) in
        the kernel."""
        if integ not in ("whitted", "cook"):
            raise ValueError(f"trace_shaded runs Whitted or Cook, not {integ!r}")
        return self(pixel, origin, direction, frame, salt_base, max_bounces,
                    style, integ=integ)

    def trace_mode(self, pixel, origin, direction, frame, mode, *, salt_base,
                   max_bounces, style="reference", nrays=1):
        """Integrator ``mode`` 0-10 on the passed-in rays -> f32[3, N]:
        ``trace_hart`` (10), ``trace_primary`` (0-6, AO with ``nrays``
        probes), ``trace_shaded`` (7, 8) or ``trace`` (9)."""
        if mode == 10:
            return self.trace_hart(pixel, origin, direction)
        if mode in PRIMARY_MODES:
            return self.trace_primary(pixel, origin, direction, frame, mode,
                                      salt_base=salt_base, nrays=nrays)
        if mode in (7, 8):
            return self.trace_shaded(pixel, origin, direction, frame,
                                     {7: "whitted", 8: "cook"}[mode],
                                     salt_base=salt_base,
                                     max_bounces=max_bounces, style=style)
        return self.trace(pixel, origin, direction, frame, salt_base,
                          max_bounces, style=style)

    def trace_hart(self, pixel, origin, direction, *, mint=0.0):
        """The Hart heat map -> f32[3, N] (:3237): MARCH_ITER steps of the
        scene distance, stopping below MARCH_EPS, in one launch of B6's
        march instance (``bigmesh_march_plain`` on the CPU); the value is
        the step of the stop times 1/(MARCH_ITER-1), 32/31 where the march
        never stopped.  ``pixel`` is unused (no random draws)."""
        o = origin.T.contiguous()
        d = direction.T.contiguous()
        iters = _on_device(
            self.tables.device,
            lambda: launch_bigmesh_march(self.hart_tables, self.hart_count,
                                         self.nodes, o, d, mint,
                                         escape=self.escape),
            lambda: bigmesh_march_plain(self.hart_tables, self.hart_count, o, d,
                                        mint))
        val = iters.to(torch.float32) * (1.0 / (MARCH_ITER - 1))
        return torch.stack([val, val, val])


# ---------------------------------------------------------------------------
# Backward: the whole-chain pullback from a record
# ---------------------------------------------------------------------------


def pack_bwd(scene: Scene) -> tuple[torch.Tensor, tuple[int, int, int, int]]:
    """Raw differentiable tables + id tables for the pullback, in the row
    form (``BWD_WIDTHS``): [T,10] triangle rows (v0, v1, v2, material id),
    [S,5] sphere rows (center, radius, material id), [P,5] plane rows
    (normal, offset, material id), [M,8] material rows (albedo, emission,
    ior, kind), one flat f32 buffer, plus the row counts (T, S, P, M).
    A material-less scene gets one zero row (``pack_bwd`` :245-253)."""
    f32 = torch.float32
    t, s, p = scene.num_triangles, scene.num_spheres, scene.num_planes
    tri = torch.cat([scene.tri_v0, scene.tri_v1, scene.tri_v2,
                     scene.tri_mat.to(f32)[:, None]], dim=-1).reshape(t, 10)
    sph = torch.cat([scene.sph_center, scene.sph_radius[:, None],
                     scene.sph_mat.to(f32)[:, None]], dim=-1).reshape(s, 5)
    pln = torch.cat([scene.pln_normal, scene.pln_d[:, None],
                     scene.pln_mat.to(f32)[:, None]], dim=-1).reshape(p, 5)
    m = scene.materials
    if m.count:
        mat = torch.cat([m.albedo, m.emission, m.ior[:, None],
                         m.kind.to(f32)[:, None]], dim=-1)
    else:
        mat = torch.zeros((1, 8), dtype=f32, device=scene.device)
    flat = torch.cat([tri.reshape(-1), sph.reshape(-1), pln.reshape(-1),
                      mat.reshape(-1)]).to(f32).contiguous()
    return flat, (t, s, p, mat.shape[0])


def _split_rows(flat, counts, widths):
    """The four families' [rows, width] blocks of a flat row-form buffer."""
    out, o = [], 0
    for rows, w in zip(counts, widths):
        out.append(flat[o:o + rows * w].reshape(rows, w))
        o += rows * w
    return out


def gtabs_from_flat(gflat, counts) -> tuple[torch.Tensor, ...]:
    """The 24 table-gradient columns, in ``DIFF_FIELDS`` order, of a flat
    gradient buffer ([T,9] | [S,4] | [P,4] | [M,7] rows)."""
    cols = []
    for block in _split_rows(gflat, counts, GRAD_WIDTHS):
        cols.extend(block.unbind(1))
    return tuple(cols)


def _bwd_f(prim, tri_l, sph_l, pln_l, mat_l, m_tri, m_sph, m_pln, active,
           miss_now, is_lam, is_mir, ru, rv, rw):
    """One bounce of the replay the pullback differentiates: the JAX
    kernel's ``f`` (pathkernel.py:1446-1560) on flat [N] lanes, with the
    winner's raw rows already looked up (``tri_l`` [N,9] etc., None for an
    empty family).  Returns the 15 outputs (o, d, thr, col, sky radiance)."""
    ox, oy, oz, dx, dy, dz, tr, tg, tb, cr, cg, cb = prim
    zeros = torch.zeros_like(ox)
    t = wnx = wny = wnz = zeros

    def clip(x):
        return torch.clamp(x, -1e6, 1e6)

    def safe_div(num, den):
        return num / _safe_den(den)

    if tri_l is not None:
        v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z = tri_l.unbind(1)
        e0x, e0y, e0z = v1x - v0x, v1y - v0y, v1z - v0z
        e1x, e1y, e1z = v2x - v0x, v2y - v0y, v2z - v0z
        nx = e0y * e1z - e0z * e1y
        ny = e0z * e1x - e0x * e1z
        nz = e0x * e1y - e0y * e1x
        dn = dx * nx + dy * ny + dz * nz
        t_t = safe_div((v0x - ox) * nx + (v0y - oy) * ny + (v0z - oz) * nz, dn)
        t = torch.where(m_tri, clip(t_t), t)
        wnx = torch.where(m_tri, nx, wnx)
        wny = torch.where(m_tri, ny, wny)
        wnz = torch.where(m_tri, nz, wnz)

    if sph_l is not None:
        cx, cy, cz, r = sph_l.unbind(1)
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        dd = dx * dx + dy * dy + dz * dz
        bh = dx * ocx + dy * ocy + dz * ocz
        ct = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = torch.clamp(bh * bh - dd * ct, min=1e-12)
        sq = torch.sqrt(disc)
        t0 = safe_div(-bh - sq, dd)
        t1 = safe_div(-bh + sq, dd)
        t_s = torch.where(t0 > 0.0, t0, t1)
        t_s = torch.where(m_sph, clip(t_s), zeros)
        t = torch.where(m_sph, t_s, t)
        wnx = torch.where(m_sph, ox + t_s * dx - cx, wnx)
        wny = torch.where(m_sph, oy + t_s * dy - cy, wny)
        wnz = torch.where(m_sph, oz + t_s * dz - cz, wnz)

    if pln_l is not None:
        lnx, lny, lnz, doff = pln_l.unbind(1)
        dn = dx * lnx + dy * lny + dz * lnz
        t_p = safe_div(doff - (ox * lnx + oy * lny + oz * lnz), dn)
        t = torch.where(m_pln, clip(t_p), t)
        wnx = torch.where(m_pln, lnx, wnx)
        wny = torch.where(m_pln, lny, wny)
        wnz = torch.where(m_pln, lnz, wnz)

    alb_r, alb_g, alb_b, em_r, em_g, em_b, ior = mat_l.unbind(1)
    sky_t = dy * 0.5 + 0.5
    ra = torch.where(miss_now, cr + tr * (_WHITE[0] + _SKY[0] * sky_t), zeros)
    ga = torch.where(miss_now, cg + tg * (_WHITE[1] + _SKY[1] * sky_t), zeros)
    ba = torch.where(miss_now, cb + tb * (_WHITE[2] + _SKY[2] * sky_t), zeros)

    cr2 = torch.where(active, cr + tr * em_r, cr)
    cg2 = torch.where(active, cg + tg * em_g, cg)
    cb2 = torch.where(active, cb + tb * em_b, cb)

    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    inv_nl = _rsqrt_safe(wnx * wnx + wny * wny + wnz * wnz)
    nX, nY, nZ = wnx * inv_nl, wny * inv_nl, wnz * inv_nl
    inv_dl = _rsqrt_safe(dx * dx + dy * dy + dz * dz)
    iX, iY, iZ = dx * inv_dl, dy * inv_dl, dz * inv_dl

    cos_view = iX * nX + iY * nY + iZ * nZ
    flipped = cos_view > 0.0
    cos_in = torch.abs(cos_view)
    nX = torch.where(flipped, -nX, nX)
    nY = torch.where(flipped, -nY, nY)
    nZ = torch.where(flipped, -nZ, nZ)
    eta = torch.where(flipped, ior, 1.0 / torch.clamp(ior, min=1e-8))

    phi = _TWO_PI * ru
    cos_t = 1.0 - 2.0 * rv
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=1e-12))
    lamX = nX + sin_t * torch.cos(phi)
    lamY = nY + sin_t * torch.sin(phi)
    lamZ = nZ + cos_t

    refX = iX + 2.0 * cos_in * nX
    refY = iY + 2.0 * cos_in * nY
    refZ = iZ + 2.0 * cos_in * nZ

    cos_out_sqr = 1.0 - eta * eta * (1.0 - cos_in * cos_in)
    cos_out = torch.sqrt(torch.clamp(cos_out_sqr, min=1e-12))
    with torch.no_grad():  # the Fresnel choice is a stop-gradient
        r_perp = (eta * cos_in - cos_out) / (eta * cos_in + cos_out)
        r_par = (cos_in - eta * cos_out) / (cos_in + eta * cos_out)
        f_refl = 0.5 * (r_perp * r_perp + r_par * r_par)
        refl = (cos_out_sqr <= 0.0) | (rw < f_refl)
    k = eta * cos_in - cos_out
    dieX = torch.where(refl, refX, eta * iX + k * nX)
    dieY = torch.where(refl, refY, eta * iY + k * nY)
    dieZ = torch.where(refl, refZ, eta * iZ + k * nZ)
    die_off = torch.where(refl, _EPSILON, -_EPSILON)

    out_dx = torch.where(is_lam, lamX, torch.where(is_mir, refX, dieX))
    out_dy = torch.where(is_lam, lamY, torch.where(is_mir, refY, dieY))
    out_dz = torch.where(is_lam, lamZ, torch.where(is_mir, refZ, dieZ))
    off = torch.where(is_lam | is_mir, _EPSILON, die_off)

    return (torch.where(active, px + off * nX, ox),
            torch.where(active, py + off * nY, oy),
            torch.where(active, pz + off * nZ, oz),
            torch.where(active, out_dx, dx),
            torch.where(active, out_dy, dy),
            torch.where(active, out_dz, dz),
            torch.where(active, tr * alb_r, tr),
            torch.where(active, tg * alb_g, tg),
            torch.where(active, tb * alb_b, tb),
            cr2, cg2, cb2, ra, ga, ba)


def bwd_plain(tables, counts, record: PathRecord, pix, frame, salt_base,
              style, g):
    """The plain PyTorch version of the whole-chain pullback.

    ``tables``/``counts`` from ``pack_bwd``; ``record`` a trace's
    ``PathRecord``; ``pix`` int64[N] pixel ids (None: 0..N-1); ``g`` the
    radiance cotangent f32[N, 3].  Per bounce, in reverse, ``torch.autograd``
    differentiates ``_bwd_f`` (the JAX kernel's replay, its formulas, not
    the search's) with respect to its inputs and the winner's rows, which
    are looked up by indexing; the lookups' pullback adds each ray's row
    cotangent into its table row in float64 (``index_add_``), so the table
    gradient is the exactly summed reference the kernel's f32 sums are
    held against.  Returns (the flat table gradient, [T,9] | [S,4] |
    [P,4] | [M,7] rows; o cotangent f32[N,3]; d cotangent f32[N,3])."""
    t, s, p, nm = counts
    fields, hits = record.fields, record.hits
    nb, _, n = fields.shape
    dev = fields.device
    if pix is None:
        pix = torch.arange(n, dtype=torch.int64, device=dev)
    rows = _split_rows(tables.detach(), counts, BWD_WIDTHS)
    diff = [blk[:, :w] for blk, w in zip(rows, GRAD_WIDTHS)]
    ids = [blk[:, -1].to(torch.int64) for blk in rows]
    mkind = rows[3][:, 7]
    g = g.reshape(n, 3)
    grads_out = [g[:, 0], g[:, 1], g[:, 2]]
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
    cot = [zeros] * 12
    if style == "standard":
        # Lanes still active after the last bounce add their gathered
        # color (:1375-1382).
        fin = (fields[nb - 1, 12] > 0.0) & (hits[nb - 1, 0] >= 0)
        cot[9:12] = [torch.where(fin, gc, zeros) for gc in grads_out]
    gacc = [torch.zeros(d.shape, dtype=torch.float64, device=dev) for d in diff]
    with torch.enable_grad():
        for b in reversed(range(nb)):
            fam = hits[b, 0].to(torch.int64)
            idx = hits[b, 1].to(torch.int64)
            act_in = fields[b, 12] > 0.0
            hit = fam >= 0
            active = act_in & hit
            miss_now = act_in & ~hit
            ru, rv, rw = (rng.u32_to_unit_float(x)
                          for x in rng.pcg3d(pix, frame, salt_base + 4 * b))
            mat_id = torch.zeros((n,), dtype=torch.int64, device=dev)
            looked, masks, rows_of = [], [], []
            for fam_id, count in enumerate((t, s, p)):
                if count == 0:
                    looked.append(None)
                    masks.append(None)
                    rows_of.append(None)
                    continue
                safe = torch.clamp(idx, 0, count - 1)
                m = fam == fam_id
                looked.append(diff[fam_id][safe].requires_grad_(True))
                masks.append(m)
                rows_of.append(safe)
                mat_id = torch.where(m, ids[fam_id][safe], mat_id)
            mi = torch.clamp(mat_id, 0, nm - 1)
            kind = mkind[mi]
            mat_l = diff[3][mi].requires_grad_(True)
            prim = [fields[b, f].detach().requires_grad_(True) for f in range(12)]
            outs = _bwd_f(prim, *looked, mat_l, *masks, active, miss_now,
                          kind == 0.0, kind == 1.0, ru, rv, rw)
            inputs = prim + [x for x in looked if x is not None] + [mat_l]
            got = list(torch.autograd.grad(outs, inputs,
                                           grad_outputs=cot + grads_out,
                                           allow_unused=True))
            cot = [c if c is not None else zeros for c in got[:12]]
            rest = got[12:]
            for k, sel in enumerate(rows_of + [mi]):
                if sel is None:
                    continue
                gk = rest.pop(0)
                if gk is not None:
                    gacc[k].index_add_(0, sel, gk.to(torch.float64))
    gflat = torch.cat([ga.reshape(-1) for ga in gacc]).to(torch.float32)
    return (gflat, torch.stack(cot[0:3], dim=-1),
            torch.stack(cot[3:6], dim=-1))


def _bwd_lib():
    lib = load_library("bwd_kernel")
    if not hasattr(lib, "_rvpt_bound"):
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.rvpt_bwd_blocks.argtypes = [i32, i32, i32, i32, i32]
        lib.rvpt_bwd_blocks.restype = i32
        lib.rvpt_bwd.argtypes = [ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr,
                                 ptr, ptr, ptr, ptr, i32, i32, i32, u32, u32,
                                 i32, ptr]
        lib.rvpt_bwd.restype = i32
        lib._rvpt_bound = True
    return lib


def launch_bwd_kernel(tables, counts, record: PathRecord, pix, frame,
                      salt_base, style, g):
    """Launch the CUDA pullback K2 on the tables' card; arguments and
    result as ``bwd_plain``.  The table gradient is summed by each warp's
    row groups, into shared memory (one copy per warp for small tables,
    one per block for large ones), and the per-block partials reduced by a
    second kernel in a fixed order.  Counts one launch (the pair) in
    ``launch_bwd_kernel.launches``."""
    t, s, p, nm = counts
    dev = tables.device
    if t > MAX_BWD_TRIANGLES:
        raise ValueError(
            f"{t} triangles exceed the backward kernel's shared-memory "
            f"staging ({MAX_BWD_TRIANGLES})")
    check_cuda(tables, torch.float32, "tables", 10 * t + 5 * s + 5 * p + 8 * nm)
    nb, nf, n = record.fields.shape
    if nf != len(RECORD_FIELDS) or record.hits.shape != (nb, 2, n):
        raise ValueError("record: need fields [B,13,N] and hits [B,2,N]")
    check_cuda(record.fields, torch.float32, "record fields", device=dev)
    check_cuda(record.hits, torch.int32, "record hits", device=dev)
    check_cuda(g, torch.float32, "cotangent", 3 * n, dev)
    if pix is not None:
        check_cuda(pix, torch.int64, "pixel", n, dev)
    lib = _bwd_lib()
    n_grad = 9 * t + 4 * s + 4 * p + 7 * nm
    blocks = lib.rvpt_bwd_blocks(n, t, s, p, nm)
    if blocks < 0:
        check_launch(lib, -blocks, "backward kernel (occupancy query)")
    go = torch.empty((n, 3), dtype=torch.float32, device=dev)
    gd = torch.empty((n, 3), dtype=torch.float32, device=dev)
    partials = torch.empty((max(n_grad * blocks, 1),), dtype=torch.float32,
                           device=dev)
    gflat = torch.empty((n_grad,), dtype=torch.float32, device=dev)
    err = lib.rvpt_bwd(
        tables.data_ptr(), t, s, p, nm,
        None if pix is None else pix.data_ptr(), record.fields.data_ptr(),
        record.hits.data_ptr(), g.data_ptr(), go.data_ptr(), gd.data_ptr(),
        partials.data_ptr(), gflat.data_ptr(), n, nb, blocks,
        int(frame) & 0xFFFFFFFF, int(salt_base) & 0xFFFFFFFF,
        int(style == "standard"), torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, err, "backward kernel")
    launch_bwd_kernel.launches += 1
    return gflat, go, gd


launch_bwd_kernel.launches = 0


def bwd_path(scene: Scene, record: PathRecord, frame, g, salt_base: int,
             style: str, pixel=None):
    """Whole-chain pullback from a record (``bwd_path`` :1801).

    ``g`` is the radiance cotangent f32[N, 3]; ``pixel`` the trace's
    int64[N] pixel ids (None: 0..N-1).  Returns (the 24 table-gradient
    columns in ``DIFF_FIELDS`` order, o cotangent f32[N,3], d cotangent
    f32[N,3]).  A scene on the card launches K2, a scene on the CPU takes
    ``bwd_plain``."""
    tables, counts = pack_bwd(scene)
    dev = tables.device
    if dev.type == "cuda":
        gflat, go, gd = launch_bwd_kernel(tables, counts, record, pixel, frame,
                                          salt_base, style, g.contiguous())
    elif dev.type == "cpu":
        gflat, go, gd = bwd_plain(tables, counts, record, pixel, frame,
                                  salt_base, style, g)
    else:
        raise ValueError(f"no backward for device {dev}")
    return gtabs_from_flat(gflat, counts), go, gd


def scene_grads_from_tables(scene: Scene, gtabs) -> dict:
    """Scene-shaped leaf gradients from the 24 table-gradient columns
    (``scene_grads_from_tables`` :1836)."""
    g = dict(zip(DIFF_FIELDS, gtabs))
    t, s, p = scene.num_triangles, scene.num_spheres, scene.num_planes
    m = scene.materials.count

    def v3(a, b, c, rows):
        return torch.stack([g[a][:rows], g[b][:rows], g[c][:rows]], dim=-1)

    return {
        "tri_v0": v3("tv0x", "tv0y", "tv0z", t),
        "tri_v1": v3("tv1x", "tv1y", "tv1z", t),
        "tri_v2": v3("tv2x", "tv2y", "tv2z", t),
        "sph_center": v3("scx", "scy", "scz", s),
        "sph_radius": g["srad"][:s],
        "pln_normal": v3("pnx", "pny", "pnz", p),
        "pln_d": g["pd"][:p],
        "albedo": v3("mar", "mag", "mab", m),
        "emission": v3("mer", "meg", "meb", m),
        "ior": g["mior"][:m],
    }
