"""Whole-path Kajiya tracer: the port of the Pallas kernel K1.

``rvpt_tpu/ops/pathkernel.py`` traces the whole Kajiya path in one Pallas
launch per group of <= 8 bounces (make_path_kernel :1115, _path_call
:1276).  Here the same function has two versions:

* ``csrc/path_kernel.cu``: hand-written CUDA for Hopper, one thread per
  pixel, the whole bounce loop in registers, one launch per trace
  (``launch_path_kernel``);
* ``trace_plain``: the same function in plain PyTorch on flat [N] tensors,
  the reference the kernel is held against.

``PathTracer.trace`` dispatches on the device of its tables: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.
Scene tables are packed in the row form (one f32 row per primitive) in the
field orders below.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from ..core import rng
from ..scene.scene import Scene
from .intersect import triangle_precompute

_BIG = 3.0e38
_DENOM_EPS = 1e-30
_TWO_PI = 6.283185307179586
_EPSILON = 5e-3  # surface offset (compute_pass.comp:9)
_WHITE = (1.0, 1.0, 1.0)
_BLUE = (0.2, 0.3, 0.7)  # sky gradient (integrators.glsl:570-571)
_SKY = tuple(b - w for b, w in zip(_BLUE, _WHITE))  # in double, as the JAX kernel

TRI_FIELDS = (
    "nx", "ny", "nz", "e0x", "e0y", "e0z", "e1x", "e1y", "e1z",
    "v0n", "v0e0", "v0e1", "g00", "g11", "g01", "inv_det", "mat",
)
SPH_FIELDS = ("cx", "cy", "cz", "rad", "mat")
PLN_FIELDS = ("nx", "ny", "nz", "doff", "mat")
MAT_FIELDS = ("ar", "ag", "ab", "er", "eg", "eb", "ior", "kind")

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
# The plain version
# ---------------------------------------------------------------------------


def _f32(x) -> float:
    return float(np.float32(x))


def _safe_den(d):
    return torch.where(torch.abs(d) < _DENOM_EPS, torch.full_like(d, _DENOM_EPS), d)


def _rsqrt_safe(x):
    return torch.rsqrt(torch.clamp(x, min=1e-30))


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
    Returns (t_best, normal xyz, material id, hit)."""
    big = torch.full_like(ox, _BIG)
    t_best = big
    wnx = torch.zeros_like(ox)
    wny = torch.zeros_like(ox)
    wnz = torch.zeros_like(ox)
    wmat = torch.zeros_like(ox)
    hit = torch.zeros_like(ox, dtype=torch.bool)

    def take(valid, t, nx, ny, nz, mat):
        nonlocal t_best, wnx, wny, wnz, wmat, hit
        t_best = torch.where(valid, t, t_best)
        wnx = torch.where(valid, nx, wnx)
        wny = torch.where(valid, ny, wny)
        wnz = torch.where(valid, nz, wnz)
        wmat = torch.where(valid, mat, wmat)
        hit = hit | valid

    for (nx, ny, nz, e0x, e0y, e0z, e1x, e1y, e1z, v0n, v0e0, v0e1,
         g00, g11, g01, inv_det, mat) in tri:
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
        take(valid, t, nx, ny, nz, mat)

    for cx, cy, cz, rad, mat in sph:
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
             mat)

    for nx, ny, nz, doff, mat in pln:
        if not float(np.float32(nx) * np.float32(nx) + np.float32(ny) * np.float32(ny)
                     + np.float32(nz) * np.float32(nz)) > 0.0:
            continue  # zero normal: never a valid plane
        dn = nx * dx + ny * dy + nz * dz
        on = nx * ox + ny * oy + nz * oz
        tp = (doff - on) / _safe_den(dn)
        valid = (tp > mint) & (tp < t_best)
        take(valid, tp, nx, ny, nz, mat)

    return t_best, wnx, wny, wnz, wmat, hit


def trace_plain(tables, counts, pix, frame, salt_base, max_bounces, style,
                rays=None, cam_params=None, cam_mode=PINHOLE, jitter_salt=0,
                mint=0.0) -> torch.Tensor:
    """The plain PyTorch version of the whole-path kernel -> f32[3, N].

    ``tables``/``counts`` from ``pack_fwd``; ``pix`` int64[N] pixel ids;
    ``rays`` six f32[N] components (ox, oy, oz, dx, dy, dz) or None to
    generate camera rays from ``cam_params``.  The bounce-b RNG salt is
    ``salt_base + 4 b``.  Mirrors ``_search``/``_shade``/``_shade_geom``
    of the JAX kernel line for line."""
    t, s, p, nm = counts
    flat = tables.tolist()
    o = 0
    tri = [flat[o + 17 * k:o + 17 * (k + 1)] for k in range(t)]
    o += 17 * t
    sph = [flat[o + 5 * k:o + 5 * (k + 1)] for k in range(s)]
    o += 5 * s
    pln = [flat[o + 5 * k:o + 5 * (k + 1)] for k in range(p)]
    o += 5 * p
    mat = tables[o:o + 8 * nm].reshape(nm, 8)

    if rays is None:
        ox, oy, oz, dx, dy, dz = _camera_rays_plain(
            cam_params.tolist(), cam_mode, pix, frame, jitter_salt)
    else:
        ox, oy, oz, dx, dy, dz = rays
    ones = torch.ones_like(ox)
    zeros = torch.zeros_like(ox)
    tr = tg = tb = ones
    cr = cg = cb = zeros
    rr = rg = rb = zeros
    active = torch.ones_like(ox, dtype=torch.bool)

    for b in range(int(max_bounces)):
        t_best, wnx, wny, wnz, wmat, hit = _search_plain(
            tri, sph, pln, ox, oy, oz, dx, dy, dz, mint)

        miss_now = active & ~hit
        st = dy * 0.5 + 0.5
        rr = torch.where(miss_now, rr + cr + tr * (_WHITE[0] + _SKY[0] * st), rr)
        rg = torch.where(miss_now, rg + cg + tg * (_WHITE[1] + _SKY[1] * st), rg)
        rb = torch.where(miss_now, rb + cb + tb * (_WHITE[2] + _SKY[2] * st), rb)
        active = active & hit

        m = mat[torch.clamp(wmat.to(torch.int64), 0, nm - 1)]
        cr = torch.where(active, cr + tr * m[:, 3], cr)
        cg = torch.where(active, cg + tg * m[:, 4], cg)
        cb = torch.where(active, cb + tb * m[:, 5], cb)

        # _shade_geom
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
        ior = m[:, 6]
        eta = torch.where(flipped, ior, 1.0 / torch.clamp(ior, min=1e-8))

        ru, rv, rw = (rng.u32_to_unit_float(x)
                      for x in rng.pcg3d(pix, frame, salt_base + 4 * b))

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

        kind = m[:, 7]
        is_lam = kind == 0.0
        is_mir = kind == 1.0
        out_dx = torch.where(is_lam, lamX, torch.where(is_mir, refX, dieX))
        out_dy = torch.where(is_lam, lamY, torch.where(is_mir, refY, dieY))
        out_dz = torch.where(is_lam, lamZ, torch.where(is_mir, refZ, dieZ))
        off = torch.where(is_lam | is_mir, _EPSILON, die_off)

        ox = torch.where(active, px + off * nX, ox)
        oy = torch.where(active, py + off * nY, oy)
        oz = torch.where(active, pz + off * nZ, oz)
        dx = torch.where(active, out_dx, dx)
        dy = torch.where(active, out_dy, dy)
        dz = torch.where(active, out_dz, dz)
        tr = torch.where(active, tr * m[:, 0], tr)
        tg = torch.where(active, tg * m[:, 1], tg)
        tb = torch.where(active, tb * m[:, 2], tb)

    if style == "standard":
        rr = torch.where(active, rr + cr, rr)
        rg = torch.where(active, rg + cg, rg)
        rb = torch.where(active, rb + cb, rb)
    return torch.stack([rr, rg, rb])


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


def _path_lib():
    from .build import load_library

    lib = load_library("path_kernel")
    if not hasattr(lib, "_rvpt_bound"):
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.rvpt_path_trace.argtypes = [
            ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            ptr, i32, u32, u32, u32, i32, i32, i32, ctypes.c_float, ptr,
        ]
        lib.rvpt_path_trace.restype = i32
        lib.rvpt_path_max_table_floats.argtypes = []
        lib.rvpt_path_max_table_floats.restype = i32
        lib.rvpt_error_string.argtypes = [i32]
        lib.rvpt_error_string.restype = ctypes.c_char_p
        lib._rvpt_bound = True
    return lib


def _check_cuda(x: torch.Tensor, dtype, name: str, n: int | None = None):
    if x.device.type != "cuda" or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {dtype} CUDA tensor, got "
            f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")
    if n is not None and x.numel() != n:
        raise ValueError(f"{name}: need {n} elements, got {x.numel()}")


def launch_path_kernel(tables, counts, pix, n, frame, salt_base, max_bounces,
                       style, rays=None, cam_params=None, cam_mode=PINHOLE,
                       jitter_salt=0, mint=0.0) -> torch.Tensor:
    """Launch the CUDA kernel -> f32[3, n] on the tables' card.

    ``pix`` int64[n] pixel ids, or None for the ids 0..n-1 (the raster
    film).  Other arguments as ``trace_plain``.  Counts one launch in
    ``launch_path_kernel.launches``."""
    t, s, p, nm = counts
    dev = tables.device
    _check_cuda(tables, torch.float32, "tables", 17 * t + 5 * s + 5 * p + 8 * nm)
    lib = _path_lib()
    if tables.numel() > lib.rvpt_path_max_table_floats():
        raise ValueError(
            f"scene tables of {tables.numel()} floats exceed the kernel's "
            f"shared-memory staging ({lib.rvpt_path_max_table_floats()})")
    if pix is not None:
        _check_cuda(pix, torch.int64, "pixel", n)
    if rays is None:
        if cam_params is None:
            raise ValueError("camera rays need cam_params")
        _check_cuda(cam_params, torch.float32, "cam_params", 24)
        ray_ptrs = [None] * 6
        cam_ptr = cam_params.data_ptr()
    else:
        for k, r in enumerate(rays):
            _check_cuda(r, torch.float32, f"ray component {k}", n)
        ray_ptrs = [r.data_ptr() for r in rays]
        cam_ptr = None
    for x in (pix, cam_params, *(rays or ())):
        if x is not None and x.device != dev:
            raise ValueError(f"inputs on {x.device}, tables on {dev}")
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rvpt_path_trace(
        tables.data_ptr(), t, s, p, nm, cam_ptr,
        None if pix is None else pix.data_ptr(), *ray_ptrs, out.data_ptr(), n,
        int(frame) & 0xFFFFFFFF, int(salt_base) & 0xFFFFFFFF,
        int(jitter_salt) & 0xFFFFFFFF, int(max_bounces),
        int(style == "standard"), int(cam_mode), float(mint), stream)
    if err != 0:
        raise RuntimeError(
            f"path kernel launch failed: {lib.rvpt_error_string(err).decode()}")
    launch_path_kernel.launches += 1
    return out


launch_path_kernel.launches = 0


class PathTracer(nn.Module):
    """Whole-path tracer for one scene: the packed tables live as a buffer
    on the scene's device.  ``trace`` runs the CUDA kernel for a scene on
    the card and the plain version for a scene on the CPU."""

    def __init__(self, scene: Scene, mint: float = 0.0):
        super().__init__()
        if scene.bvh is not None:
            raise NotImplementedError("BVH scenes wait for the BVH port")
        tables, self.counts = pack_fwd(scene)
        self.register_buffer("tables", tables)
        self.mint = float(mint)

    def trace(self, pixel, origin, direction, frame, salt_base, max_bounces,
              style="reference", gen_rays=False, cam_params=None,
              cam_mode=PINHOLE, jitter_salt=0):
        """Trace full Kajiya paths -> (r, g, b), each f32[N] (the JAX
        ``PathTracer.trace`` interface); ``forward`` returns them as one
        f32[3, N] tensor.

        ``pixel`` is an int64[N] tensor of pixel ids, or an int N meaning
        the raster ids 0..N-1.  With ``gen_rays`` the camera rays are made
        inside the trace from ``cam_params`` (``camera_params``) and
        ``origin``/``direction`` are ignored; otherwise they are f32[N,3]
        tensors or (x, y, z) tuples of f32[N]."""
        return self(pixel, origin, direction, frame, salt_base, max_bounces,
                    style, gen_rays, cam_params, cam_mode, jitter_salt).unbind(0)

    def forward(self, pixel, origin, direction, frame, salt_base, max_bounces,
                style="reference", gen_rays=False, cam_params=None,
                cam_mode=PINHOLE, jitter_salt=0) -> torch.Tensor:
        dev = self.tables.device
        if isinstance(pixel, int):
            n, pix = pixel, None
        else:
            n, pix = pixel.shape[0], pixel
        rays = None
        if not gen_rays:
            if isinstance(origin, tuple):
                comps = (*origin, *direction)
            else:
                comps = (origin[:, 0], origin[:, 1], origin[:, 2],
                         direction[:, 0], direction[:, 1], direction[:, 2])
            rays = tuple(c.contiguous() for c in comps)
        if dev.type == "cuda":
            out = launch_path_kernel(
                self.tables, self.counts, pix, n, frame, salt_base, max_bounces,
                style, rays=rays, cam_params=cam_params, cam_mode=cam_mode,
                jitter_salt=jitter_salt, mint=self.mint)
        elif dev.type == "cpu":
            if pix is None:
                pix = torch.arange(n, dtype=torch.int64)
            out = trace_plain(
                self.tables, self.counts, pix, frame, salt_base, max_bounces,
                style, rays=rays, cam_params=cam_params, cam_mode=cam_mode,
                jitter_salt=jitter_salt, mint=self.mint)
        else:
            raise ValueError(f"no path tracer for device {dev}")
        return out
