"""The SoA replay of rvpt_tpu_torch (ops/replay_soa.py) against rvpt_tpu's,
and the plain versions of its gather and segment sum against the JAX
lookup kernels B7a-d.

The replay: the same hit records (traced once by the port on the CPU)
through both packages' ``kajiya_replay_soa``, on the Cornell box, the
sphere-and-plane scene and a 120-triangle soup whose triangle tables take
the grouped lookup (more than ``_LOOKUP_UNROLL`` rows: on the JAX side the
Pallas kernels in interpret mode, here the plain versions).  Films 24x16,
3 bounces, a seeded cotangent.  Bars, tests/test_fast_grad.py:101-146's:
value rtol 1e-4, atol 1e-5; gradients of albedo, emission and the three
vertex tables rtol 1e-3, atol 1e-6.

The lookups, at the sizes of tests/test_fast_grad.py:306-385 (every tier
of the JAX kernels: <= 4,096 rows, the range-skipping big tables with
clustered ids and a partial trailing block, past 131,072 rows): the
gather exact, the segment sum within rtol 1e-5, atol 1e-5 (f32 sums in
other orders; the port's plain version sums in float64); the >131,072-row
case against numpy's ``np.add.at`` rather than JAX's interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvpt_tpu import FilmConfig as JFilmConfig
from rvpt_tpu.core import rng as jrng
from rvpt_tpu.models import camera as jcam
from rvpt_tpu.ops import replay_soa as jrs
from rvpt_tpu.render import _pixel_grid as j_pixel_grid
from rvpt_tpu.scene import builtin as jbuiltin
from rvpt_tpu.scene.scene import SceneBuilder as JSceneBuilder
from rvpt_tpu_torch import convert
from rvpt_tpu_torch.ops import pathkernel as tpk
from rvpt_tpu_torch.ops import replay_soa as trs

W, H, BOUNCES, FRAME, SALT = 24, 16, 3, 2, 16
GROUPS = {"albedo": ("materials", "albedo"), "emission": ("materials", "emission"),
          "tri_v0": ("scene", "tri_v0"), "tri_v1": ("scene", "tri_v1"),
          "tri_v2": ("scene", "tri_v2")}


def _soup_jax(n_tri=120, seed=23):
    """The 120-triangle soup of tests/test_fast_grad.py:245 (no BVH here),
    with a mirror and a dielectric triangle kind and an emissive sphere."""
    r = np.random.default_rng(seed)
    c = r.uniform(-2, 2, size=(n_tri, 3)).astype(np.float32)
    c[:, 2] += 4.0
    e1 = r.normal(0, 0.5, size=(n_tri, 3)).astype(np.float32)
    e2 = r.normal(0, 0.5, size=(n_tri, 3)).astype(np.float32)
    b = JSceneBuilder()
    mats = (b.add_material(albedo=(0.6, 0.5, 0.4)),
            b.add_material(albedo=(0.9, 0.9, 0.9), kind=1),
            b.add_material(albedo=(1.0, 1.0, 1.0), kind=2, ior=1.5))
    for k, (a, v1, v2) in enumerate(zip(c, c + e1, c + e2)):
        b.add_triangle(tuple(a), tuple(v1), tuple(v2), mats[k % 3])
    lm = b.add_material(albedo=(0, 0, 0), emission=(4, 4, 4))
    b.add_sphere((0.0, 5.0, 2.0), 1.0, lm)
    return b.build(), jbuiltin.sphere_plane(aspect=W / H)[1]


def _scene_dict(js):
    from rvpt_tpu_torch.scene.scene import ARRAY_FIELDS

    d = {k: np.asarray(getattr(js, k)) for k in ARRAY_FIELDS}
    for k in ("albedo", "emission", "ior", "kind"):
        d[f"materials.{k}"] = np.asarray(getattr(js.materials, k))
    return d


CASES = {
    "cornell": (lambda: jbuiltin.cornell_box(aspect=W / H), "reference"),
    "sphere_plane": (lambda: jbuiltin.sphere_plane(aspect=W / H), "standard"),
    "soup120": (_soup_jax, "standard"),
}


def _jax_with(js, leaves):
    mats = dataclasses.replace(js.materials, **{
        k: v for k, v in leaves.items() if GROUPS[k][0] == "materials"})
    return dataclasses.replace(js, materials=mats, **{
        k: v for k, v in leaves.items() if GROUPS[k][0] == "scene"})


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One scene in both packages, the port's hit records on it, and the JAX
    replay's value and gradients on those records."""
    make, style = CASES[request.param]
    js, cam = make()
    cfg = JFilmConfig(width=W, height=H)
    pixel, xs, ys = j_pixel_grid(cfg)
    ju, jv = jrng.uniform2(pixel, jnp.uint32(0), jnp.uint32(0))
    ray = jcam.generate_rays(cam, (xs.astype(jnp.float32) + ju) / W,
                             1.0 - (ys.astype(jnp.float32) + jv) / H)
    ts = convert.scene_from_numpy(_scene_dict(js), "cpu")
    tpix = torch.from_numpy(np.asarray(pixel).astype(np.int64))
    o = torch.from_numpy(np.array(ray.origin))
    d = torch.from_numpy(np.array(ray.direction))
    pt = tpk.PathTracer(ts)
    _, rec = pt.trace(tpix, o, d, FRAME, SALT, BOUNCES, style=style,
                      collect_states=True)
    fams, idxs = pt.hits_from_record(rec)
    n = tpix.numel()
    cot = (np.random.default_rng(5).normal(size=(n, 3)) / (3 * n)).astype(np.float32)
    jf, ji = jnp.asarray(fams.numpy(), jnp.int32), jnp.asarray(idxs.numpy(), jnp.int32)

    def replay(leaves):
        return jrs.kajiya_replay_soa(_jax_with(js, leaves), ray.origin, ray.direction,
                                     pixel, jnp.uint32(FRAME), jnp.uint32(SALT), jf,
                                     ji, style)

    leaves = {k: getattr(js.materials if where == "materials" else js, k)
              for k, (where, _) in GROUPS.items()}
    value, vjp = jax.vjp(replay, leaves)
    (grads,) = vjp(jnp.asarray(cot))
    return dict(name=request.param, style=style, ts=ts, pixel=tpix, o=o, d=d,
                fams=fams, idxs=idxs, cot=torch.from_numpy(cot),
                value=np.asarray(value), grads={k: np.asarray(v) for k, v in grads.items()})


def test_replay_soa_matches_jax(case):
    """Value and gradients of the port's kajiya_replay_soa against JAX's on
    the same hit records (the soup's triangles take the grouped lookup)."""
    c = case
    ts = c["ts"]
    leaves = {k: getattr(ts.materials if where == "materials" else ts, k)
              .clone().requires_grad_(True) for k, (where, _) in GROUPS.items()}
    mats = dataclasses.replace(ts.materials, albedo=leaves["albedo"],
                               emission=leaves["emission"])
    s = dataclasses.replace(ts, materials=mats, tri_v0=leaves["tri_v0"],
                            tri_v1=leaves["tri_v1"], tri_v2=leaves["tri_v2"])
    if c["name"] == "soup120":
        assert ts.num_triangles > trs._LOOKUP_UNROLL
    out = trs.kajiya_replay_soa(s, c["o"], c["d"], c["pixel"], FRAME, SALT,
                                c["fams"], c["idxs"], c["style"])
    np.testing.assert_allclose(out.detach().numpy(), c["value"], rtol=1e-4, atol=1e-5)
    grads = torch.autograd.grad(out, list(leaves.values()), c["cot"],
                                allow_unused=True)
    total = 0.0
    for k, g in zip(leaves, grads):
        want = c["grads"][k]
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6, err_msg=k)
        total += float(np.abs(want).sum())
    assert total > 0.0


def test_replay_soa_reproduces_the_tracer(case):
    """The replay of a trace's own records gives its radiance (the primal
    of the "soa" route is the tracer's; the replay is its backward)."""
    c = case
    pt = tpk.PathTracer(c["ts"])
    r, g, b = pt.trace(c["pixel"], c["o"], c["d"], FRAME, SALT, BOUNCES,
                       style=c["style"])
    out = trs.kajiya_replay_soa(c["ts"], c["o"], c["d"], c["pixel"], FRAME, SALT,
                                c["fams"], c["idxs"], c["style"])
    share = np.isclose(out.numpy(), torch.stack([r, g, b], -1).numpy(),
                       rtol=1e-4, atol=1e-4).mean()
    assert share >= 0.995


# ---------------------------------------------------------------------------
# The lookups
# ---------------------------------------------------------------------------


def _tables(r, t_rows, c):
    return r.standard_normal((c, t_rows)).astype(np.float32)


def _add_at(idx, g, t_rows):
    ref = np.zeros((g.shape[0], t_rows), np.float64)
    for k in range(g.shape[0]):
        np.add.at(ref[k], idx, g[k].astype(np.float64))
    return ref


def _clustered(r, t_rows, n):
    """Ids drawn per 1,024-ray block from a 512-row window at a non-zero
    offset, the last block partial (test_fast_grad.py:347)."""
    blk = jrs._SEG_BLK
    bases = [2 * jrs._TBLK + 100, 5 * jrs._TBLK, 8 * jrs._TBLK + 400, 4 * jrs._TBLK + 50]
    return np.concatenate([r.integers(b, min(b + 512, t_rows), blk)
                           for b in bases])[:n]


# name -> (rows, rays, columns, the JAX kernels to hold the plain versions to)
LOOKUPS = {
    "mm": (1282, 2048 + 300, 10, (jrs._gather_mm, jrs._segsum_mm)),
    "mm_big": (4097 + 1500, 2048 + 300, 5, (jrs._gather_mm_big, jrs._segsum_mm_big)),
    "mm_big_clustered": (9 * jrs._TBLK + 77, 3 * jrs._SEG_BLK + 300, 3,
                         (jrs._gather_mm_big, jrs._segsum_mm_big)),
}


@pytest.mark.parametrize("name", list(LOOKUPS))
def test_lookup_plain_versions_match_jax_kernels(name):
    t_rows, n, c, (jgather, jsegsum) = LOOKUPS[name]
    r = np.random.default_rng(7)
    tabs = _tables(r, t_rows, c)
    idx = (_clustered(r, t_rows, n) if name.endswith("clustered")
           else r.integers(0, t_rows, n)).astype(np.int32)
    g = r.standard_normal((c, n)).astype(np.float32)
    jtabs = tuple(jnp.asarray(t) for t in tabs)
    jidx = jnp.asarray(idx)
    want = np.stack([np.asarray(o) for o in jgather(jtabs, jidx)])
    got = trs.gather_plain(torch.from_numpy(tabs), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tabs[:, idx])
    want = np.asarray(jsegsum(jidx, tuple(jnp.asarray(x) for x in g), t_rows)).T
    got = trs.segsum_plain(torch.from_numpy(idx), torch.from_numpy(g), t_rows)
    assert got.dtype == torch.float32 and got.shape == (c, t_rows)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _add_at(idx, g, t_rows), rtol=1e-6,
                               atol=1e-6)


def test_lookup_group_gradient_matches_jax():
    """_lookup_group's gradient on a 5,597-row table (the grouped lookup:
    the gather forward, the segment sum backward) against JAX's, and its
    trailing channels past n_diff take no gradient."""
    t_rows, n, c = 4097 + 1500, 2048 + 300, 5
    r = np.random.default_rng(7)
    tabs = _tables(r, t_rows, c)
    idx = r.integers(0, t_rows, n).astype(np.int32)
    jidx = jnp.asarray(idx)

    def jloss(ts):
        return sum(jnp.sum(o ** 2) for o in jrs._lookup_group(ts, jidx, n_diff=4))

    want = jax.grad(jloss)(tuple(jnp.asarray(t) for t in tabs))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in tabs]
    out = trs._lookup_group(leaves, torch.from_numpy(idx).long(), n_diff=4)
    got = torch.autograd.grad(sum(torch.sum(o ** 2) for o in out), leaves,
                              allow_unused=True)
    for k in range(4):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-4)
    assert got[4] is None and not np.asarray(want[4]).any()
    for o, t in zip(out, tabs):
        np.testing.assert_array_equal(o.detach().numpy(), t[idx])


def test_huge_table_lookup_matches_numpy():
    """Past the JAX kernels' 131,072 rows (their chunked tier): one lookup
    for any row count, against numpy indexing and np.add.at, ids on both
    sides of the chunk boundary; and an empty index."""
    big = jrs._SEG_MM_BIG_MAX
    t_rows, n, c = big + 2 * jrs._TBLK + 123, 2 * jrs._SEG_BLK + 77, 4
    r = np.random.default_rng(3)
    tabs = _tables(r, t_rows, c)
    idx = np.concatenate([r.integers(0, t_rows, n - 600),
                          r.integers(big - 300, big + 300, 300),
                          r.integers(t_rows - 200, t_rows, 300)]).astype(np.int32)
    g = r.standard_normal((c, n)).astype(np.float32)
    tt, ti = torch.from_numpy(tabs), torch.from_numpy(idx)
    np.testing.assert_array_equal(trs.gather(tt, ti).numpy(), tabs[:, idx])
    np.testing.assert_allclose(trs.segsum(ti, torch.from_numpy(g), t_rows).numpy(),
                               _add_at(idx, g, t_rows), rtol=1e-5, atol=1e-5)
    empty = torch.zeros(0, dtype=torch.int32)
    assert trs.gather(tt, empty).shape == (c, 0)
    assert not trs.segsum(empty, torch.zeros(c, 0), t_rows).any()


@pytest.mark.parametrize("case,n_col,t_rows,n", [
    ("one_row", 9, 50, 5000),
    ("distinct", 9, 3000, 3000),
    ("window", 9, 20482, 9000),
    ("random", 1, 700, 5000),
    ("random", 10, 700, 5000),
    ("one_row", 9, 1, 5000),
    ("random", 9, 700, 0),
])
def test_segsum_cases_match_numpy(case, n_col, t_rows, n):
    """The segment sum's CPU route (segsum_plain) on the inputs its kernel's
    card tests use: every id on one row, every id distinct, ids in a
    sliding window of rows, C = 1 and 10, T = 1, n = 0; against np.add.at
    in float64."""
    r = np.random.default_rng(n_col * 1000 + n)
    if case == "one_row":
        idx = np.full(n, t_rows // 2)
    elif case == "distinct":
        idx = r.permutation(t_rows)[:n]
    elif case == "window":
        idx = np.arange(n) * (t_rows - 600) // n + r.integers(0, 600, n)
    else:
        idx = r.integers(0, t_rows, n)
    idx = idx.astype(np.int32)
    g = r.standard_normal((n_col, n)).astype(np.float32)
    got = trs.segsum(torch.from_numpy(idx), torch.from_numpy(g), t_rows)
    assert got.shape == (n_col, t_rows) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _add_at(idx, g, t_rows), rtol=1e-5,
                               atol=1e-5)


def test_lookup_launchers_refuse_cpu_tensors():
    tabs = torch.zeros(2, 100)
    idx = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        trs.launch_gather(tabs, idx)
    with pytest.raises(ValueError, match="CUDA"):
        trs.launch_segsum(idx, torch.zeros(2, 8), 100)
