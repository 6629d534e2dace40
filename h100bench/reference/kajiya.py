"""Plain PyTorch reference of the Kajiya path tracer the cells drive.

It imports nothing of the port.  Each part is a frozen copy of the port's
plain arithmetic, expression for expression, so that on the card it rounds
as the kernels do (the port holds its kernels bit for bit to these plain
versions):

* ``pcg3d``, ``unit_float``: rvpt_tpu_torch/core/rng.py:36-80;
* ``camera_vector``, ``kernel_rays``: ops/pathkernel.py:340-371
  (camera_params) and :414-456 (_camera_rays_plain, pinhole), the rays K1
  makes itself;
* ``camera_matrix``, ``torch_rays``: models/camera.py:63-109, render.py:
  65-73 (jittered_camera_rays, a big mesh's display rays) and
  train/inverse.py:132-146 (the trainer's rays, which divide by the film
  size where the display multiplies by its reciprocal);
* ``triangle_rows``: ops/intersect.py:69-83 (triangle_precompute);
* ``search``: ops/pathkernel.py:459-530 (_search_plain, the row form:
  triangles first) and :590-627 (_search_tris_last, the BVH forms:
  spheres and planes first), as one test per [ray, triangle] pair over
  clusters of consecutive triangles whose padded boxes the ray enters; a
  cluster the ray misses holds no valid hit, so the winner is the brute
  force's;
* ``_shade``, ``trace``: ops/pathkernel.py:743-749 (_sky_add), :751-806
  (_shade_geom_plain), :813-884 (_shade_plain, Kajiya), :887-911
  (_finish_plain), :914-922 (_start_state), :925-997 (trace_plain);
* ``ema``: ops/film.py:32-39 (accumulate).

Where the scene's vertices, albedo or emission require a gradient, the
winner's t and normal are worked out again from the gathered vertices
(the search itself selects and does not differentiate), and every gather
reads a float64 copy, so that autograd sums each row's gradient in
float64.  Lanes that miss take a safe t and normal: no output reads them,
and they keep infinities out of the backward pass.

Floats run in ``dtype`` (float32; bfloat16 for the precision control).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

MASK = 0xFFFFFFFF
LCG_MUL, LCG_ADD = 1664525, 1013904223
INV_2_24 = 1.0 / 16777216.0
BIG = 3.0e38
DENOM_EPS = 1e-30
PI = 3.141592653589793
TWO_PI = 6.283185307179586
EPSILON = 5e-3
WHITE = (1.0, 1.0, 1.0)
BLUE = (0.2, 0.3, 0.7)
SKY = tuple(b - w for b, w in zip(BLUE, WHITE))
JITTER_SITE = 0
INTEGRATOR_SITE = 16
BOUNCE_STRIDE = 4
# The port routes a BVH scene of more triangles than this through the big-
# mesh tracer, whose display rays are made in PyTorch (pathkernel.py:224).
BIG_ROUTE_TRIS = 1024
# Consecutive triangles per cluster of the two-level search.
CLUSTER = 64


@dataclass(frozen=True)
class Scene:
    """A scene as the benchmark makes it: triangles in the order made,
    spheres, planes, materials, and the camera (pinhole)."""

    v0: torch.Tensor  # f32[T, 3]
    v1: torch.Tensor
    v2: torch.Tensor
    tri_mat: torch.Tensor  # i64[T]
    sph_center: torch.Tensor  # f32[S, 3]
    sph_radius: torch.Tensor  # f32[S]
    sph_mat: torch.Tensor  # i64[S]
    pln_normal: torch.Tensor  # f32[P, 3]
    pln_d: torch.Tensor  # f32[P]
    pln_mat: torch.Tensor  # i64[P]
    albedo: torch.Tensor  # f32[M, 3]
    emission: torch.Tensor  # f32[M, 3]
    ior: torch.Tensor  # f32[M]
    kind: torch.Tensor  # i64[M]: 0 Lambert, 1 mirror, 2 dielectric
    cam_translation: tuple
    cam_rotation: tuple
    cam_fov: float
    bvh: bool  # the port attaches a BVH to it

    @property
    def device(self):
        return self.v0.device

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)

    def big_mesh(self) -> bool:
        return self.bvh and self.v0.shape[0] > BIG_ROUTE_TRIS


# ---------------------------------------------------------------------------
# RNG and camera rays
# ---------------------------------------------------------------------------


def pcg3d(x, y, z):
    """PCG3D on int64 lanes holding u32 values; ``y`` and ``z`` may be ints."""
    dev = x.device
    x = x.to(torch.int64) & MASK
    y = torch.as_tensor(y, dtype=torch.int64, device=dev) & MASK
    z = torch.as_tensor(z, dtype=torch.int64, device=dev) & MASK
    x = (x * LCG_MUL + LCG_ADD) & MASK
    y = (y * LCG_MUL + LCG_ADD) & MASK
    z = (z * LCG_MUL + LCG_ADD) & MASK
    x = (x + y * z) & MASK
    y = (y + z * x) & MASK
    z = (z + x * y) & MASK
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = (x + y * z) & MASK
    y = (y + z * x) & MASK
    z = (z + x * y) & MASK
    return x, y, z


def unit_float(bits, dtype=torch.float32):
    """Top 24 bits of a u32 -> uniform in [0, 1), exact in float32."""
    return ((bits >> 8).to(torch.float32) * INV_2_24).to(dtype)


def rng3(pix, frame, salt, dtype=torch.float32):
    return tuple(unit_float(b, dtype) for b in pcg3d(pix, frame, salt))


def _axis_rotation(axis, radians):
    c, s = torch.cos(radians), torch.sin(radians)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if axis == 0:
        rows = [(one, zero, zero), (zero, c, -s), (zero, s, c)]
    elif axis == 1:
        rows = [(c, zero, s), (zero, one, zero), (-s, zero, c)]
    else:
        rows = [(c, -s, zero), (s, c, zero), (zero, zero, one)]
    return torch.stack([torch.stack(r) for r in rows])


def camera_matrix(scene: Scene, device):
    """4x4 camera-to-world matrix, T @ R_y @ R_x @ R_z, on ``device``."""
    rot = torch.tensor(scene.cam_rotation, dtype=torch.float32,
                       device=device) * (PI / 180.0)
    r = (_axis_rotation(1, rot[0]) @ _axis_rotation(0, rot[1])
         @ _axis_rotation(2, rot[2]))
    m = torch.eye(4, dtype=torch.float32, device=device)
    m[:3, :3] = r
    m[:3, 3] = torch.tensor(scene.cam_translation, dtype=torch.float32,
                            device=device)
    return m


def camera_vector(scene: Scene, width: int, height: int) -> list:
    """The 24 camera floats K1 reads, built on the host in float32."""
    m = camera_matrix(scene, "cpu")
    fov = torch.tensor(scene.cam_fov, dtype=torch.float32)
    proj = 1.0 / torch.tan(0.5 * fov * (PI / 180.0))
    tail = torch.zeros(8, dtype=torch.float32)
    tail[0] = width / height
    tail[1] = proj
    tail[2] = 1.0 / width
    tail[3] = 1.0 / height
    tail[4] = float(width)
    return torch.cat([m.reshape(16), tail]).tolist()


def kernel_rays(cam: list, pix, frame, jitter_salt=0, dtype=torch.float32):
    """Jittered pinhole rays as K1 makes them from pixel ids: six [N]."""
    ju32, jv32, _ = pcg3d(pix, frame, jitter_salt)
    ju, jv = unit_float(ju32), unit_float(jv32)
    width = int(cam[20])
    xs = (pix % width).to(torch.float32)
    ys = torch.div(pix, width, rounding_mode="floor").to(torch.float32)
    cx = (xs + ju) * cam[18]
    cy = 1.0 - (ys + jv) * cam[19]

    def m(r, c):
        return cam[4 * r + c]

    def f32(x):
        return torch.tensor(x, dtype=torch.float32).item()

    ones = torch.ones_like(cx)
    u = cam[16] * (2.0 * cx - 1.0)
    v = 2.0 * cy - 1.0
    w = cam[17]
    if dtype != torch.float32:
        u, v, ones = u.to(dtype), v.to(dtype), ones.to(dtype)
    dx = m(0, 0) * u + m(0, 1) * v + f32(f32(m(0, 2)) * f32(w))
    dy = m(1, 0) * u + m(1, 1) * v + f32(f32(m(1, 2)) * f32(w))
    dz = m(2, 0) * u + m(2, 1) * v + f32(f32(m(2, 2)) * f32(w))
    inv = torch.rsqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-30))
    return (m(0, 3) * ones, m(1, 3) * ones, m(2, 3) * ones,
            dx * inv, dy * inv, dz * inv)


def torch_rays(scene: Scene, width, height, pix, frame, salt0=0,
               divide=False, dtype=torch.float32):
    """Jittered pinhole rays made in PyTorch: the big mesh's display rays
    (``divide`` False) or the trainer's (True) -> six [N]."""
    # The one float32 matmul of the reference: without TF32, as the program.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = pix.device
    ju, jv, _ = rng3(pix, frame, salt0 + JITTER_SITE)
    xs = (pix % width).to(torch.float32)
    ys = torch.div(pix, width, rounding_mode="floor").to(torch.float32)
    if divide:
        cx = (xs + ju) / width
        cy = 1.0 - (ys + jv) / height
    else:
        cx = (xs + ju) * (1.0 / width)
        cy = 1.0 - (ys + jv) * (1.0 / height)
    m = camera_matrix(scene, dev)
    fov = torch.tensor(scene.cam_fov, dtype=torch.float32, device=dev)
    hfov = fov * (PI / 180.0)
    u = (width / height) * (2.0 * cx - 1.0)
    v = 2.0 * cy - 1.0
    w = 1.0 / torch.tan(0.5 * hfov)
    local = torch.stack([u, v, w.expand(u.shape)], dim=-1)
    if dtype != torch.float32:
        local, m = local.to(dtype), m.to(dtype)
    d = local @ m[:3, :3].T
    n2 = torch.sum(d * d, dim=-1)
    inv = torch.where(n2 > 0.0, 1.0 / torch.sqrt(torch.clamp(n2, min=1e-16)),
                      torch.zeros_like(n2))
    d = d * inv[..., None]
    o = m[:3, 3].expand(d.shape)
    return (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------


def _safe_den(d):
    return torch.where(torch.abs(d) < DENOM_EPS, torch.full_like(d, DENOM_EPS), d)


def triangle_rows(v0, v1, v2, tri_mat):
    """[T, 17] rows: n, e0, e1, v0.n, v0.e0, v0.e1, g00, g11, g01,
    1/det, material (pack_fwd's columns)."""
    e0 = v1 - v0
    e1 = v2 - v0
    n = torch.linalg.cross(e0, e1, dim=-1)
    g00 = torch.sum(e0 * e0, dim=-1)
    g11 = torch.sum(e1 * e1, dim=-1)
    g01 = torch.sum(e0 * e1, dim=-1)
    inv_det = _safe_den(g00 * g11 - g01 * g01)
    inv_det = torch.ones_like(g00) / inv_det
    return torch.cat([n, e0, e1, torch.stack([
        torch.sum(v0 * n, dim=-1), torch.sum(v0 * e0, dim=-1),
        torch.sum(v0 * e1, dim=-1), g00, g11, g01, inv_det,
        tri_mat.to(v0.dtype)], dim=-1)], dim=-1)


class Tables:
    """What one scene's searches read: triangle rows padded to whole
    clusters, the clusters' padded boxes, sphere, plane and material
    rows."""

    def __init__(self, scene: Scene, dtype=torch.float32):
        f = (lambda x: x.detach().to(dtype))
        t = scene.v0.shape[0]
        self.n_tri = t
        n_clu = -(-t // CLUSTER)
        rows = triangle_rows(f(scene.v0), f(scene.v1), f(scene.v2), scene.tri_mat)
        pad = torch.zeros((n_clu * CLUSTER - t, 17), dtype=dtype, device=scene.device)
        self.rows = torch.cat([rows, pad])
        vs = torch.stack([f(scene.v0), f(scene.v1), f(scene.v2)], 1).float()
        lo = torch.full((n_clu * CLUSTER, 3), float("inf"), device=scene.device)
        hi = torch.full_like(lo, float("-inf"))
        lo[:t], hi[:t] = vs.amin(1), vs.amax(1)
        if t:
            eps = 1e-4 * (vs.max() - vs.min()) + 1e-6
            self.lo = (lo.reshape(n_clu, CLUSTER, 3).amin(1) - eps).to(dtype)
            self.hi = (hi.reshape(n_clu, CLUSTER, 3).amax(1) + eps).to(dtype)
        self.sph = [f(scene.sph_center), f(scene.sph_radius), scene.sph_mat]
        self.pln = [f(scene.pln_normal), f(scene.pln_d), scene.pln_mat]
        self.mat = torch.cat([f(scene.albedo), f(scene.emission),
                              f(scene.ior)[:, None],
                              scene.kind.to(dtype)[:, None]], dim=-1)
        self.dtype = dtype


def _tri_test(rows, o, d, mint):
    """The metric-tensor test of rows [..., K, 17] against rays whose six
    components are [..., 1] -> (t, valid) [..., K]."""
    (nx, ny, nz, e0x, e0y, e0z, e1x, e1y, e1z, v0n, v0e0, v0e1, g00, g11,
     g01, inv_det, _) = rows.unbind(-1)
    ox, oy, oz = o
    dx, dy, dz = d
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
    return t, (mint < t) & (u > 0.0) & (v > 0.0) & (u + v < 1.0)


def _first_min(t, dim):
    """(min, index of its first occurrence) along ``dim``."""
    tb = torch.amin(t, dim=dim)
    iota = torch.arange(t.shape[dim], device=t.device)
    shape = [1] * t.dim()
    shape[dim] = t.shape[dim]
    first = torch.amin(torch.where(t == tb.unsqueeze(dim), iota.reshape(shape),
                                   t.shape[dim]), dim=dim)
    return tb, first


RAY_CHUNK = 1 << 18
PAIR_CHUNK = 1 << 19


def _triangles(tab: Tables, o, d, mint):
    """Closest triangle per ray: (t [N], index [N], -1 on a miss)."""
    n = o[0].shape[0]
    dev = o[0].device
    big = torch.full((n,), BIG, dtype=tab.dtype, device=dev)
    best_t, best_i = big.clone(), torch.full((n,), -1, dtype=torch.int64, device=dev)
    if tab.n_tri == 0 or n == 0:
        return best_t, best_i
    n_clu = tab.lo.shape[0]
    pair_ray, pair_t, pair_i = [], [], []
    for r0 in range(0, n, RAY_CHUNK):
        rs = slice(r0, r0 + RAY_CHUNK)
        oc = [c[rs, None] for c in o]
        dc = [c[rs, None] for c in d]
        iv = [1.0 / _safe_den(c) for c in dc]
        f0 = [(tab.lo[None, :, k] - oc[k]) * iv[k] for k in range(3)]
        f1 = [(tab.hi[None, :, k] - oc[k]) * iv[k] for k in range(3)]
        t0 = torch.maximum(torch.maximum(torch.minimum(f0[0], f1[0]),
                                         torch.minimum(f0[1], f1[1])),
                           torch.minimum(f0[2], f1[2]))
        t1 = torch.minimum(torch.minimum(torch.maximum(f0[0], f1[0]),
                                         torch.maximum(f0[1], f1[1])),
                           torch.maximum(f0[2], f1[2]))
        ray, clu = torch.nonzero(t1 >= torch.clamp(t0, min=float(mint)),
                                 as_tuple=True)
        del f0, f1, t0, t1
        ray = ray + r0
        for p0 in range(0, ray.shape[0], PAIR_CHUNK):
            pr, pc = ray[p0:p0 + PAIR_CHUNK], clu[p0:p0 + PAIR_CHUNK]
            ids = pc[:, None] * CLUSTER + torch.arange(CLUSTER, device=dev)
            rows = tab.rows[ids]
            t, ok = _tri_test(rows, [c[pr, None] for c in o],
                              [c[pr, None] for c in d], mint)
            tmin, k = _first_min(torch.where(ok, t, torch.full_like(t, BIG)), 1)
            keep = tmin < BIG
            pair_ray.append(pr[keep])
            pair_t.append(tmin[keep])
            pair_i.append((pc * CLUSTER + k)[keep])
    if not pair_ray:
        return best_t, best_i
    ray, t, idx = torch.cat(pair_ray), torch.cat(pair_t), torch.cat(pair_i)
    best_t = best_t.scatter_reduce(0, ray, t, "amin")
    cand = torch.where(t == best_t[ray], idx, torch.full_like(idx, 1 << 62))
    first = torch.full((n,), 1 << 62, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, ray, cand, "amin")
    best_i = torch.where(best_t < BIG, first, best_i)
    return best_t, best_i


def _spheres(tab: Tables, o, d, mint):
    """Closest sphere per ray: (t, index, -1 on a miss)."""
    center, radius, _ = tab.sph
    n = o[0].shape[0]
    big = torch.full((n,), BIG, dtype=tab.dtype, device=o[0].device)
    if center.shape[0] == 0:
        return big, torch.full((n,), -1, dtype=torch.int64, device=big.device)
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    cx, cy, cz = center[None, :, 0], center[None, :, 1], center[None, :, 2]
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    dd = dx * dx + dy * dy + dz * dz
    bh = dx * ocx + dy * ocy + dz * ocz
    ct = ocx * ocx + ocy * ocy + ocz * ocz - (radius * radius)[None, :]
    disc = bh * bh - dd * ct
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    dds = _safe_den(dd)
    t0 = (-bh - sq) / dds
    t1 = (-bh + sq) / dds
    bigs = torch.full_like(t0, BIG)
    ts = torch.where(t0 > mint, t0, torch.where(t1 > mint, t1, bigs))
    ts = torch.where((disc > 0.0) & (radius[None, :] > 0.0), ts, bigs)
    tb, j = _first_min(ts, 1)
    return tb, torch.where(tb < BIG, j, -1)


def _planes(tab: Tables, o, d, mint):
    normal, doff, _ = tab.pln
    n = o[0].shape[0]
    big = torch.full((n,), BIG, dtype=tab.dtype, device=o[0].device)
    if normal.shape[0] == 0:
        return big, torch.full((n,), -1, dtype=torch.int64, device=big.device)
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    nx, ny, nz = normal[None, :, 0], normal[None, :, 1], normal[None, :, 2]
    dn = nx * dx + ny * dy + nz * dz
    on = nx * ox + ny * oy + nz * oz
    tp = (doff[None, :] - on) / _safe_den(dn)
    live = (nx * nx + ny * ny + nz * nz) > 0.0
    tp = torch.where((tp > mint) & live, tp, torch.full_like(tp, BIG))
    tb, j = _first_min(tp, 1)
    return tb, torch.where(tb < BIG, j, -1)


def search(tab: Tables, o, d, mint, tris_last):
    """Closest hit of every ray -> (t, family, index);
    family 0 triangle, 1 sphere, 2 plane, -1 a miss.  A later family in the
    order wins only with a strictly smaller t."""
    tt, ti = _triangles(tab, o, d, mint)
    ts, si = _spheres(tab, o, d, mint)
    tp, pi = _planes(tab, o, d, mint)
    fams = [(1, ts, si), (2, tp, pi), (0, tt, ti)] if tris_last else \
        [(0, tt, ti), (1, ts, si), (2, tp, pi)]
    t = torch.full_like(tt, BIG)
    fam = torch.full_like(ti, -1)
    idx = torch.full_like(ti, -1)
    for f, tf, jf in fams:
        better = (jf >= 0) & (tf < t)
        t = torch.where(better, tf, t)
        fam = torch.where(better, f, fam)
        idx = torch.where(better, jf, idx)
    return t, fam, idx


# ---------------------------------------------------------------------------
# Shading
# ---------------------------------------------------------------------------


ONE_HOT_ROWS = 64


def _gather(x, idx):
    """Rows of ``x`` at ``idx``.  Where ``x`` needs a gradient the rows are
    read in float64, so that the backward sums each row's gradient in
    float64: a table of up to ONE_HOT_ROWS rows through a one-hot product
    (its backward a product too, rather than atomic adds into a few rows),
    a larger one by indexing."""
    if not (x.requires_grad and torch.is_grad_enabled()):
        return x[idx]
    if x.shape[0] <= ONE_HOT_ROWS:
        hot = torch.nn.functional.one_hot(idx, x.shape[0]).double()
        return (hot @ x.double()).to(x.dtype)
    return x.double()[idx].to(x.dtype)


def _winner(scene: Scene, tab: Tables, o, d, hit, fam, idx, t_search):
    """The winner's t, normal (three [N]) and material id; a lane that
    misses gets t 0 and normal +z.  Triangle hits are worked out again from
    their vertices where those need a gradient."""
    dt = tab.dtype
    zero, one = torch.zeros_like(t_search), torch.ones_like(t_search)
    is_t, is_s, is_p = hit & (fam == 0), hit & (fam == 1), hit & (fam == 2)
    t = torch.where(hit, t_search, zero)
    nx, ny, nz = zero, zero, one
    mat = torch.zeros_like(idx)
    if tab.n_tri:
        j = torch.where(is_t, idx, 0)
        if scene.v0.requires_grad and torch.is_grad_enabled():
            rows = triangle_rows(_gather(scene.v0, j), _gather(scene.v1, j),
                                 _gather(scene.v2, j), scene.tri_mat[j])
            tt, _ = _tri_test(rows[:, None, :], [c[:, None] for c in o],
                              [c[:, None] for c in d], 0.0)
            t = torch.where(is_t, tt[:, 0], t)
        else:
            rows = tab.rows[j]
        nx = torch.where(is_t, rows[:, 0], nx)
        ny = torch.where(is_t, rows[:, 1], ny)
        nz = torch.where(is_t, rows[:, 2], nz)
        mat = torch.where(is_t, scene.tri_mat[j], mat)
    if tab.sph[0].shape[0]:
        j = torch.where(is_s, idx, 0)
        c = tab.sph[0][j]
        nx = torch.where(is_s, o[0] + t * d[0] - c[:, 0], nx)
        ny = torch.where(is_s, o[1] + t * d[1] - c[:, 1], ny)
        nz = torch.where(is_s, o[2] + t * d[2] - c[:, 2], nz)
        mat = torch.where(is_s, scene.sph_mat[j], mat)
    if tab.pln[0].shape[0]:
        j = torch.where(is_p, idx, 0)
        pn = tab.pln[0][j]
        nx = torch.where(is_p, pn[:, 0], nx)
        ny = torch.where(is_p, pn[:, 1], ny)
        nz = torch.where(is_p, pn[:, 2], nz)
        mat = torch.where(is_p, scene.pln_mat[j], mat)
    return t.to(dt), nx.to(dt), ny.to(dt), nz.to(dt), mat


def _shade(scene, tab, pix, frame, salt, state, o, d, hit, win):
    """One Kajiya bounce at the winner -> the new state."""
    (ox, oy, oz, dx, dy, dz, tr, tg, tb, cr, cg, cb, rr, rg, rb, active) = state
    t_best, wnx, wny, wnz, mid = win
    sky_t = dy * 0.5 + 0.5
    mask = active & ~hit
    rr = torch.where(mask, rr + cr + tr * (WHITE[0] + SKY[0] * sky_t), rr)
    rg = torch.where(mask, rg + cg + tg * (WHITE[1] + SKY[1] * sky_t), rg)
    rb = torch.where(mask, rb + cb + tb * (WHITE[2] + SKY[2] * sky_t), rb)
    active = active & hit

    mid = torch.clamp(mid, 0, scene.albedo.shape[0] - 1)
    alb = _gather(scene.albedo, mid).to(tab.dtype)
    emi = _gather(scene.emission, mid).to(tab.dtype)
    ior = tab.mat[mid, 6]
    kind = tab.mat[mid, 7]
    cr = torch.where(active, cr + tr * emi[:, 0], cr)
    cg = torch.where(active, cg + tg * emi[:, 1], cg)
    cb = torch.where(active, cb + tb * emi[:, 2], cb)

    px = ox + t_best * dx
    py = oy + t_best * dy
    pz = oz + t_best * dz
    inv_nl = torch.rsqrt(torch.clamp(wnx * wnx + wny * wny + wnz * wnz, min=1e-30))
    nX, nY, nZ = wnx * inv_nl, wny * inv_nl, wnz * inv_nl
    inv_dl = torch.rsqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-30))
    iX, iY, iZ = dx * inv_dl, dy * inv_dl, dz * inv_dl
    cos_view = iX * nX + iY * nY + iZ * nZ
    flipped = cos_view > 0.0
    cos_in = torch.abs(cos_view)
    nX = torch.where(flipped, -nX, nX)
    nY = torch.where(flipped, -nY, nY)
    nZ = torch.where(flipped, -nZ, nZ)
    eta = torch.where(flipped, ior, 1.0 / torch.clamp(ior, min=1e-8))

    ru, rv, rw = rng3(pix, frame, salt, tab.dtype)
    phi = TWO_PI * ru
    cos_t = 1.0 - 2.0 * rv
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    lamX = nX + sin_t * torch.cos(phi)
    lamY = nY + sin_t * torch.sin(phi)
    lamZ = nZ + cos_t
    refX = iX + 2.0 * cos_in * nX
    refY = iY + 2.0 * cos_in * nY
    refZ = iZ + 2.0 * cos_in * nZ
    cos_out_sqr = 1.0 - eta * eta * (1.0 - cos_in * cos_in)
    # sqrt(max(x, 0)), written so that a lane at x <= 0 sends no infinity
    # back through the square root.
    pos = cos_out_sqr > 0.0
    cos_out = torch.where(pos, torch.sqrt(torch.where(pos, cos_out_sqr, 1.0)), 0.0)
    r_perp = (eta * cos_in - cos_out) / (eta * cos_in + cos_out)
    r_par = (cos_in - eta * cos_out) / (cos_in + eta * cos_out)
    f_refl = 0.5 * (r_perp * r_perp + r_par * r_par)
    refl = (cos_out_sqr <= 0.0) | (rw < f_refl)
    k = eta * cos_in - cos_out
    dieX = torch.where(refl, refX, eta * iX + k * nX)
    dieY = torch.where(refl, refY, eta * iY + k * nY)
    dieZ = torch.where(refl, refZ, eta * iZ + k * nZ)
    die_off = torch.where(refl, EPSILON, -EPSILON)
    is_lam = kind == 0.0
    is_mir = kind == 1.0
    out_dx = torch.where(is_lam, lamX, torch.where(is_mir, refX, dieX))
    out_dy = torch.where(is_lam, lamY, torch.where(is_mir, refY, dieY))
    out_dz = torch.where(is_lam, lamZ, torch.where(is_mir, refZ, dieZ))
    off = torch.where(is_lam | is_mir, EPSILON, die_off).to(tab.dtype)

    ox = torch.where(active, px + off * nX, ox)
    oy = torch.where(active, py + off * nY, oy)
    oz = torch.where(active, pz + off * nZ, oz)
    dx = torch.where(active, out_dx, dx)
    dy = torch.where(active, out_dy, dy)
    dz = torch.where(active, out_dz, dz)
    tr = torch.where(active, tr * alb[:, 0], tr)
    tg = torch.where(active, tg * alb[:, 1], tg)
    tb = torch.where(active, tb * alb[:, 2], tb)
    return (ox, oy, oz, dx, dy, dz, tr, tg, tb, cr, cg, cb, rr, rg, rb, active)


def trace(scene: Scene, tab: Tables, rays, pix, frame, salt_base, bounces,
          style="standard", tris_last=False, mint=0.0, census=None):
    """Kajiya paths of the rays (six [N]) -> radiance [3, N].  ``census``,
    a dict, gets per bounce the lanes of each kind of work: "search" the
    live lanes (the record's live slots), "end" those that miss and end on
    the sky, "scatter" those that hit and scatter, "tri"/"sph"/"pln" the
    hits by family and "glass" the hits on a dielectric."""
    dt = tab.dtype
    rays = tuple(c.to(dt) for c in rays)
    ones = torch.ones_like(rays[0])
    zeros = torch.zeros_like(rays[0])
    state = (*rays, ones, ones, ones, zeros, zeros, zeros, zeros, zeros, zeros,
             torch.ones_like(rays[0], dtype=torch.bool))
    for b in range(int(bounces)):
        o, d, active = state[:3], state[3:6], state[15]
        lanes = torch.nonzero(active).squeeze(1)
        with torch.no_grad():
            ts, fs, js = search(tab, [c[lanes].detach() for c in o],
                                      [c[lanes].detach() for c in d], mint,
                                      tris_last)
        n = active.shape[0]
        t_s = torch.full((n,), BIG, dtype=dt, device=active.device)
        fam = torch.full((n,), -1, dtype=torch.int64, device=active.device)
        idx = fam.clone()
        t_s[lanes], fam[lanes], idx[lanes] = ts, fs, js
        hit = fam >= 0
        win = _winner(scene, tab, o, d, hit, fam, idx, t_s)
        if census is not None:
            live_hit = active & hit
            glass = live_hit & (tab.mat[torch.clamp(win[4], 0), 7] == 2.0)
            for key, mask in (("search", active), ("end", active & ~hit),
                              ("scatter", live_hit),
                              ("tri", live_hit & (fam == 0)),
                              ("sph", live_hit & (fam == 1)),
                              ("pln", live_hit & (fam == 2)), ("glass", glass)):
                census.setdefault(key, []).append(int(mask.sum()))
        state = _shade(scene, tab, pix, frame, salt_base + BOUNCE_STRIDE * b,
                       state, o, d, hit, win)
    rr, rg, rb, active = state[12], state[13], state[14], state[15]
    cr, cg, cb = state[9], state[10], state[11]
    if style == "standard":
        rr = torch.where(active, rr + cr, rr)
        rg = torch.where(active, rg + cg, rg)
        rb = torch.where(active, rb + cb, rb)
    return torch.stack([rr, rg, rb])


def ema(accum, sample, n: int):
    """The film's update after ``n`` frames: (accum n + sample) / (n + 1)."""
    fn = float(n)
    return (accum * fn + sample) / (fn + 1.0)
