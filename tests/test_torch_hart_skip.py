"""The design of the Hart march kernel B4 (csrc/hart_kernel.cu), mirrored in
plain PyTorch on the CPU: its per-triangle invariants, its skip test and its
warm-started, skipping march.

* The invariant form of the iq distance (the triangle's point-free terms
  computed once, then the point's) equals ``_tri_dist2`` bit for bit on the
  Cornell box, on rabbit and on degenerate triangles.
* The skip test, with its margins, never skips a triangle at a running
  minimum above the distance ``_tri_dist2`` computes for it: checked at
  every point of a 24x16 Cornell and rabbit march and at seeded random
  points near edges, vertices and planes, far away, and on degenerate
  triangles.  (Skipping is monotone in the minimum, so the smallest float
  above the triangle's own distance is the one minimum to try.)
* The skipping march equals ``hart_plain`` bit for bit, skips no triangle
  below its running minimum, and meets the bar of
  tests/test_torch_primary_hart.py against the JAX kernel run in interpret
  mode (>= 99% of channels within 1e-4).

The card's counting instance (``count_hart_sweep``, tests/test_torch_cuda.py)
checks the kernel itself the same way.  Inputs come from seeded numpy
generators.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvpt_tpu import FilmConfig as JFilmConfig
from rvpt_tpu.ops import pathkernel as jpk
from rvpt_tpu.render import _pixel_grid as j_pixel_grid
from rvpt_tpu.scene import builtin as jbuiltin
from rvpt_tpu_torch import FilmConfig
from rvpt_tpu_torch.ops import pathkernel as tpk
from rvpt_tpu_torch.scene import builtin as tbuiltin

W, H = 24, 16
FRAME = int(np.random.default_rng(5).integers(0, 1000))
SCENES = ("cornell_box", "rabbit")
F32 = torch.float32
# The kernel's margins (hart_kernel.cu SLACK, REL) and constants.
SLACK = 2.0 ** -18
REL = 1.0 + 2.0 ** -18
TINY = torch.tensor(2e-20, dtype=F32)
BIG = torch.tensor(3.0e38, dtype=F32)


def _tracer(scene_name):
    ts, tc = getattr(tbuiltin, scene_name)(aspect=W / H, device="cpu")
    return tpk.PathTracer(ts), tpk.camera_params(tc, FilmConfig(W, H)), tc.mode


def _rows(pt):
    return pt.hart_tables.reshape(pt.hart_count, 9)


def _degenerate_rows():
    """Collinear, repeated-vertex, tiny, sliver and near-collinear triangles."""
    r = np.random.default_rng(23)
    a = r.normal(size=3)
    e = r.normal(size=3)
    rows = [
        np.r_[a, a + e, a + 2.5 * e],                       # collinear
        np.r_[a, a, a + e],                                 # a repeated vertex
        np.r_[a, a, a],                                     # a point
        np.r_[a, a + 1e-7 * e, a + 1e-7 * r.normal(size=3)],  # tiny
        np.r_[a, a + e, a + 0.5 * e + 1e-6 * r.normal(size=3)],  # sliver
        np.r_[a, a + 1e3 * e, a + 1e3 * e + 1e-3 * r.normal(size=3)],  # long sliver
        np.r_[a, a + 1e-3 * e, a + 1e-3 * r.normal(size=3)],  # small
    ]
    return torch.from_numpy(np.stack(rows).astype(np.float32))


def make_inv(rows):
    """The kernel's make_inv on [T, 9] vertex rows -> dict of [T] columns."""
    ax, ay, az, bx, by, bz, cx, cy, cz = rows.unbind(1)
    bax, bay, baz = bx - ax, by - ay, bz - az
    cbx, cby, cbz = cx - bx, cy - by, cz - bz
    acx, acy, acz = ax - cx, ay - cy, az - cz
    nx = bay * acz - baz * acy
    ny = baz * acx - bax * acz
    nz = bax * acy - bay * acx
    raw = nx * nx + ny * ny + nz * nz
    lo = torch.tensor(1e-20, dtype=F32)

    def clamp(x):
        return torch.maximum(x, lo)

    e2ba = clamp(bax * bax + bay * bay + baz * baz)
    e2cb = clamp(cbx * cbx + cby * cby + cbz * cbz)
    e2ac = clamp(acx * acx + acy * acy + acz * acz)
    l2 = torch.maximum(torch.maximum(e2ba, e2cb), e2ac)
    ln = torch.sqrt(l2)
    vt = torch.maximum(torch.maximum(ax.abs() + ay.abs() + az.abs(),
                                     bx.abs() + by.abs() + bz.abs()),
                       cx.abs() + cy.abs() + cz.abs())
    kpl = torch.where(raw >= TINY, SLACK * (ln * (1.0 + l2 / torch.sqrt(raw)) + vt),
                      torch.tensor(float("inf"), dtype=F32))

    def mid(p, q, s):
        return 0.5 * (torch.minimum(torch.minimum(p, q), s)
                      + torch.maximum(torch.maximum(p, q), s))

    sx, sy, sz = mid(ax, bx, cx), mid(ay, by, cy), mid(az, bz, cz)

    def d2(x, y, z):
        return (x - sx) * (x - sx) + (y - sy) * (y - sy) + (z - sz) * (z - sz)

    rad = torch.sqrt(torch.maximum(torch.maximum(d2(ax, ay, az), d2(bx, by, bz)),
                                   d2(cx, cy, cz)))

    def cross_n(ex, ey, ez):
        return (ey * nz - ez * ny, ez * nx - ex * nz, ex * ny - ey * nx)

    return dict(a=(ax, ay, az), b=(bx, by, bz), c=(cx, cy, cz),
                ba=(bax, bay, baz), cb=(cbx, cby, cbz), ac=(acx, acy, acz),
                nor=(nx, ny, nz), nor2=clamp(raw), e2ba=e2ba, e2cb=e2cb,
                e2ac=e2ac, kpl=kpl, sc=(sx, sy, sz), ksph=rad * REL + kpl,
                xba=cross_n(bax, bay, baz), xcb=cross_n(cbx, cby, cbz),
                xac=cross_n(acx, acy, acz))


def take(inv, idx):
    """The invariants of triangle idx (an int or an int64 tensor) per lane."""
    return {k: (tuple(c[idx] for c in v) if isinstance(v, tuple) else v[idx])
            for k, v in inv.items()}


def dot(u, q):
    return u[0] * q[0] + u[1] * q[1] + u[2] * q[2]


def plane_dn(t, p):
    pa = tuple(pc - ac for pc, ac in zip(p, t["a"]))
    return pa, dot(t["nor"], pa)


def inv_dist2(t, p, pa, dn):
    """The kernel's inv_dist2 -> (squared distance, edge branch taken)."""
    pb = tuple(pc - bc for pc, bc in zip(p, t["b"]))
    pc_ = tuple(pc - cc for pc, cc in zip(p, t["c"]))
    edge = (torch.sign(dot(t["xba"], pa)) + torch.sign(dot(t["xcb"], pb))
            + torch.sign(dot(t["xac"], pc_))) < 2.0

    def seg(e, e2, q):
        h = torch.clamp(dot(e, q) / e2, 0.0, 1.0)
        r = [ec * h - qc for ec, qc in zip(e, q)]
        return r[0] * r[0] + r[1] * r[1] + r[2] * r[2]

    d_edge = torch.minimum(torch.minimum(seg(t["ba"], t["e2ba"], pa),
                                         seg(t["cb"], t["e2cb"], pb)),
                           seg(t["ac"], t["e2ac"], pc_))
    return torch.where(edge, d_edge, dn * dn / t["nor2"]), edge


def reach(best, p):
    return (torch.sqrt(best) + SLACK * (p[0].abs() + p[1].abs() + p[2].abs())) * REL


def skip(t, p, dn, reach_t, planes=None):
    """The kernel's skip test; ``planes`` gets the lanes the plane decided."""
    tp = reach_t + t["kpl"]
    plane = dn * dn > tp * tp * t["nor2"]
    if planes is not None:
        planes.append(plane)
    s = [pc - sc for pc, sc in zip(p, t["sc"])]
    ts = reach_t + t["ksph"]
    return plane | (s[0] * s[0] + s[1] * s[1] + s[2] * s[2] > ts * ts)


def march_points(pt, cp, mode):
    """Every point the plain march visits on the 24x16 film (its steps
    while live) -> f32[3, P]."""
    ox, oy, oz, dx, dy, dz = tpk._camera_rays_plain(cp.tolist(), mode,
                                                    torch.arange(W * H), FRAME, 0)
    cols = _rows(pt).unbind(1)
    p = [ox, oy, oz]
    done = torch.zeros_like(ox, dtype=torch.bool)
    seen = []
    for _ in range(tpk.MARCH_ITER):
        seen.append(torch.stack(p)[:, ~done])
        d2 = torch.amin(tpk._tri_dist2(p[0][:, None], p[1][:, None], p[2][:, None],
                                       *(c[None] for c in cols)), dim=1)
        dist = torch.sqrt(d2)
        stop = dist < tpk.MARCH_EPS
        adv = ~done & ~stop
        p = [torch.where(adv, pc + dist * dc, pc) for pc, dc in zip(p, (dx, dy, dz))]
        done = done | stop
    return torch.cat(seen, dim=1)


def random_points(rows, seed):
    """Seeded points near each triangle's vertices, edges and plane, at
    scales from 1e-7 to 1e2 of the triangle, and far away (to 1e6)."""
    r = np.random.default_rng(seed)
    v = rows.double().numpy().reshape(-1, 3, 3)
    pts = []
    for a, b, c in v:
        nor = np.cross(b - a, c - a)
        nor = nor / max(np.linalg.norm(nor), 1e-30)
        size = max(np.linalg.norm(b - a), np.linalg.norm(c - a), 1e-6)
        for s in 10.0 ** np.arange(-7, 3):
            for base in (a, b, c, (a + b) / 2, (b + c) / 2, (c + a) / 2,
                         a + r.uniform() * (b - a), (a + b + c) / 3):
                pts.append(base + s * size * r.normal(size=3))
                pts.append(base + s * size * r.choice([-1, 1]) * nor)
    far = r.normal(size=(64, 3)) * 10.0 ** r.uniform(1, 6, size=(64, 1))
    return torch.from_numpy(np.concatenate([np.array(pts), far]).T.astype(np.float32))


def check_bound(rows, p):
    """At the smallest running minimum above each triangle's own computed
    distance, the skip test must keep the triangle -> (points x triangles
    checked, share skipped at the point's own minimum over the others)."""
    inv = make_inv(rows)
    p = tuple(c[:, None] for c in p)
    t = {k: (tuple(c[None] for c in v) if isinstance(v, tuple) else v[None])
         for k, v in inv.items()}
    pa, dn = plane_dn(t, p)
    d2, _ = inv_dist2(t, p, pa, dn)
    want = tpk._tri_dist2(*p, *(c[None] for c in rows.unbind(1)))
    assert torch.equal(d2, want)
    above = torch.nextafter(d2, torch.tensor(float("inf")))
    wrong = skip(t, p, dn, reach(above, p))
    assert not wrong.any(), f"{int(wrong.sum())} triangles skipped below the minimum"
    best = torch.amin(d2, dim=1, keepdim=True)
    return d2.numel(), skip(t, p, dn, reach(best, p)).float().mean().item()


@pytest.mark.parametrize("scene_name", SCENES + ("degenerate",))
def test_invariant_distance_matches_tri_dist2(scene_name):
    """The invariant form of the distance, bit for bit with _tri_dist2 at
    seeded points near the triangles and far from them."""
    rows = (_degenerate_rows() if scene_name == "degenerate"
            else _rows(_tracer(scene_name)[0]))
    p = random_points(rows, 1)
    inv = make_inv(rows)
    t = {k: (tuple(c[None] for c in v) if isinstance(v, tuple) else v[None])
         for k, v in inv.items()}
    p3 = tuple(c[:, None] for c in p)
    pa, dn = plane_dn(t, p3)
    d2, edge = inv_dist2(t, p3, pa, dn)
    want = tpk._tri_dist2(*p3, *(c[None] for c in rows.unbind(1)))
    assert torch.equal(d2, want)
    assert edge.any() and (~edge).any()  # both branches taken


@pytest.mark.parametrize("scene_name", SCENES)
def test_skip_bound_on_the_march(scene_name):
    """Every point of the 24x16 march, every triangle: the bound with its
    margin is at or below the computed distance, and skips most triangles
    at the point's minimum (not a vacuous test)."""
    pt, cp, mode = _tracer(scene_name)
    n, share = check_bound(_rows(pt), march_points(pt, cp, mode))
    assert n > 10_000
    assert share > 0.3, share


@pytest.mark.parametrize("scene_name", SCENES + ("degenerate",))
def test_skip_bound_near_edges_and_vertices(scene_name):
    rows = (_degenerate_rows() if scene_name == "degenerate"
            else _rows(_tracer(scene_name)[0]))
    check_bound(rows, random_points(rows, 2))


def escape_ball(rows):
    """The kernel's escape_ball: (centre x, y, z, squared radius)."""
    v = rows.reshape(-1, 3)
    lo, hi = v.amin(dim=0), v.amax(dim=0)
    c = 0.5 * (lo + hi)
    e = hi - lo
    r = 0.5 * torch.sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2])
    m = torch.maximum(torch.maximum(c[0].abs(), c[1].abs()), c[2].abs())
    rr = r * REL + tpk.ESCAPE_MARGIN + SLACK * (m + r)
    return c[0], c[1], c[2], rr * rr


def skip_march(rows, pix, cam_params, mode, work):
    """The kernel's counting instance: per step the escape test, a warm
    seed (the previous step's nearest triangle), then every other triangle
    in order, skipped when the test says so, else its full distance; it
    marches on past each escape (as the parent did) and returns what the
    kernel writes, with ``work`` the sums of its counts."""
    ox, oy, oz, dx, dy, dz = tpk._camera_rays_plain(cam_params.tolist(), mode,
                                                    pix, FRAME, 0)
    n_tri = rows.shape[0]
    inv = make_inv(rows)
    ball = escape_ball(rows)
    p = (ox, oy, oz)
    iters = torch.full_like(ox, tpk.MARCH_ITER, dtype=torch.int32)
    done = torch.zeros_like(ox, dtype=torch.bool)
    escaped = torch.zeros_like(done)
    near = torch.full_like(ox, -1, dtype=torch.int64)
    for key in tpk.HART_COUNTS:
        work[key] = 0

    def add(key, mask):
        work[key] += int(mask.sum())

    for step in range(tpk.MARCH_ITER):
        live = ~done
        v = [pc - bc for pc, bc in zip(p, ball)]
        escaped = escaped | (live & (v[0] * dx + v[1] * dy + v[2] * dz >= 0.0)
                             & (v[0] * v[0] + v[1] * v[1] + v[2] * v[2] >= ball[3]))
        own = live & ~escaped
        add("steps", own)
        add("parent_steps", live)
        seeded = live & (near >= 0)
        t = take(inv, near.clamp(min=0))
        pa, dn = plane_dn(t, p)
        d_seed, seed_edge = inv_dist2(t, p, pa, dn)
        best = torch.where(seeded, d_seed, BIG)
        cur = torch.where(seeded, near, -1)
        for key in ("seeds", "edge", "all_edge", "face", "all_face"):
            add(key, (seeded & own if key in ("seeds", "edge", "face") else seeded)
                & (seed_edge if "edge" in key else ~seed_edge if "face" in key else True))
        r = reach(best, p)
        for k in range(n_tri):
            act = live & (near != k)
            t = take(inv, k)
            pa, dn = plane_dn(t, p)
            planes = []
            sk = skip(t, p, dn, r, planes)
            d2, edge = inv_dist2(t, p, pa, dn)
            add("tests", act & own)
            add("plane_skips", act & own & planes[0])
            add("bad", act & sk & (d2 < best))
            ev = act & ~sk
            add("edge", ev & edge & own)
            add("face", ev & ~edge & own)
            lower = ev & (d2 < best)
            best = torch.where(lower, d2, best)
            cur = torch.where(lower, k, cur)
            r = torch.where(lower, reach(best, p), r)
            add("all_edge", act & edge)
            add("all_face", act & ~edge)
        near = torch.where(live, cur, near)
        dist = torch.sqrt(best)
        stop = dist < tpk.MARCH_EPS
        iters = torch.where(live & stop & ~escaped, step, iters)
        add("late", live & stop & escaped)
        adv = live & ~stop
        p = tuple(torch.where(adv, pc + dist * dc, pc) for pc, dc in zip(p, (dx, dy, dz)))
        done = done | stop
    val = iters.to(F32) * (1.0 / (tpk.MARCH_ITER - 1))
    return torch.stack([val, val, val])


@pytest.fixture(scope="module")
def jax_harts():
    """The JAX Hart kernel on both scenes in interpret mode, once."""
    pixel, _, _ = j_pixel_grid(JFilmConfig(W, H))
    out = {}
    for scene_name in SCENES:
        js, jc = getattr(jbuiltin, scene_name)(aspect=W / H)
        rgb = jpk.trace_hart(js, pixel, jnp.uint32(FRAME),
                             cam_params=jpk.camera_params(jc, JFilmConfig(W, H)),
                             cam_mode=jc.mode, jitter_salt=0, interpret=True)
        out[scene_name] = np.stack([np.asarray(c) for c in rgb])
    return out


@pytest.mark.parametrize("scene_name", SCENES)
def test_skipping_march_matches_hart_plain(jax_harts, scene_name):
    pt, cp, mode = _tracer(scene_name)
    pix = torch.arange(W * H)
    work = {}
    got = skip_march(_rows(pt), pix, cp, mode, work)
    want = tpk.hart_plain(pt.hart_tables, pt.hart_count, pix, FRAME, cp, mode, 0)
    assert torch.equal(got, want)
    assert work["bad"] == 0 and work["late"] == 0
    t = pt.hart_count
    assert work["all_face"] + work["all_edge"] == work["parent_steps"] * t
    assert work["tests"] + work["seeds"] == work["steps"] * t
    assert work["steps"] < work["parent_steps"] / 2, work  # the escapes
    full = work["face"] + work["edge"]
    assert work["seeds"] <= full < work["steps"] * t * 0.75, work
    share = np.isclose(got.numpy(), jax_harts[scene_name], rtol=1e-4, atol=1e-4).mean()
    assert share >= 0.99, f"only {share:.4%} of channels match the JAX kernel"
