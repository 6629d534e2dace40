"""Scene ingest of rvpt_tpu_torch against the JAX package: OBJ parsing and
the procedural meshes, the binned-SAH builder (NumPy and native), the BVH
attachment, the lockstep traversal oracle, the slab test, the BVH's trip
through ``convert`` and the node packing of the kernels' walk.

Bars: host arrays (vertices, faces, trees, permutations) equal exactly;
traversal hits index-equal on >= 99.9% of rays with t within rtol 1e-6
(the JAX walk's), and equal to the brute-force search (tests/test_bvh.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvpt_tpu.ops import intersect as jint
from rvpt_tpu.ops import traverse as jtrav
from rvpt_tpu.scene import builtin as jbuiltin
from rvpt_tpu.scene import bvh as jbvh
from rvpt_tpu.scene import obj_io as jobj
from rvpt_tpu.scene.scene import SceneBuilder as JSceneBuilder
from rvpt_tpu_torch import convert
from rvpt_tpu_torch.core.types import Ray
from rvpt_tpu_torch.native import bvh_native, get_lib, obj_native
from rvpt_tpu_torch.ops import intersect as tint
from rvpt_tpu_torch.ops import pathkernel as tpk
from rvpt_tpu_torch.ops import traverse as ttrav
from rvpt_tpu_torch.scene import builtin as tbuiltin
from rvpt_tpu_torch.scene import bvh as tbvh
from rvpt_tpu_torch.scene import obj_io as tobj
from rvpt_tpu_torch.scene.scene import SceneBuilder

SOUPS = ((1, 1), (2, 2), (17, 3), (300, 9), (257, 3))


def _soup(n, seed, spread=3.0):
    r = np.random.default_rng(seed)
    v0 = r.uniform(-spread, spread, (n, 3)).astype(np.float32)
    v1 = v0 + r.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    v2 = v0 + r.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    return v0, v1, v2


def _scenes(n, seed):
    """The same triangle soup in both packages, without a BVH."""
    jb, tb = JSceneBuilder(), SceneBuilder()
    for b in (jb, tb):
        m = b.add_material(albedo=(1, 1, 1))
        for a, c, d in zip(*_soup(n, seed)):
            b.add_triangle(a, c, d, m)
    return jb.build(), tb.build("cpu")


def _rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _tree_equal(a, b):
    return (np.array_equal(a.first, b.first) and np.array_equal(a.count, b.count)
            and np.array_equal(a.prim_indices, b.prim_indices)
            and np.array_equal(a.bmin, b.bmin) and np.array_equal(a.bmax, b.bmax))


def test_obj_parse_matches_jax():
    txt = "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\nf -4 -3 -2\n# c\n"
    for got, want in zip(tobj.parse_obj(txt), jobj.parse_obj(txt)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="out of range"):
        tobj.parse_obj("v 0 0 0\nf 1 2 3\n")


def test_obj_round_trip_and_rabbit(tmp_path):
    v, f = tobj.make_icosphere(subdiv=1)
    path = str(tmp_path / "ico.obj")
    tobj.save_obj(path, v, f)
    v2, f2 = tobj.load_obj(path)
    assert np.allclose(v, v2, atol=1e-5) and np.array_equal(f, f2)
    from rvpt_tpu.config import get_asset_path as jasset
    from rvpt_tpu_torch.config import get_asset_path

    assert get_asset_path("models/rabbit.obj") == jasset("models/rabbit.obj")
    got = tobj.load_obj(get_asset_path("models/rabbit.obj"))
    with open(get_asset_path("models/rabbit.obj")) as fh:
        want = jobj.parse_obj(fh.read())
    assert got[1].shape == (143, 3)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("subdiv", [0, 2, 3])
def test_icosphere_matches_jax(subdiv):
    for got, want in zip(tobj.make_icosphere(subdiv), jobj.make_icosphere(subdiv)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("n", [2, 9, 60])
def test_terrain_matches_jax(n):
    for got, want in zip(tobj.make_terrain(n=n), jobj.make_terrain(n=n)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("n,seed", SOUPS)
def test_build_bvh_matches_jax(n, seed):
    centers, bmin, bmax = tbvh.triangle_bounds(*_soup(n, seed))
    got = tbvh.build_bvh(centers, bmin, bmax)
    assert _tree_equal(got, jbvh.build_bvh(centers, bmin, bmax))
    tbvh.validate(got, bmin, bmax)
    assert len(got.first) <= max(2 * n - 1, 1)


def test_build_bvh_icosphere_and_degenerate():
    v, f = jobj.make_icosphere(2)
    tris = (v[f[:, 0]], v[f[:, 1]], v[f[:, 2]])
    # All 20 triangles identical: binning cannot split, the median does.
    same = (np.zeros((20, 3), np.float32), np.full((20, 3), 0.5, np.float32),
            np.tile(np.array([0.5, 0.0, 0.2], np.float32), (20, 1)))
    for v0, v1, v2 in (tris, same):
        centers, bmin, bmax = tbvh.triangle_bounds(v0, v1, v2)
        got = tbvh.build_bvh(centers, bmin, bmax)
        assert _tree_equal(got, jbvh.build_bvh(centers, bmin, bmax))
        tbvh.validate(got, bmin, bmax)


@pytest.mark.parametrize("n,seed", SOUPS[2:])
def test_native_builder_matches_numpy(n, seed):
    if get_lib() is None:
        pytest.skip("the native library cannot be built here")
    centers, bmin, bmax = tbvh.triangle_bounds(*_soup(n, seed))
    got = bvh_native.build(centers, bmin, bmax)
    assert _tree_equal(got, tbvh.build_bvh(centers, bmin, bmax))


def test_native_obj_matches_python(tmp_path):
    if get_lib() is None:
        pytest.skip("the native library cannot be built here")
    path = str(tmp_path / "q.obj")
    with open(path, "w") as fh:
        fh.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                 "f 1/1/1 2/2/2 3/3/3 4/4/4\nf -4 -3 -2\n")
    vn, fn = obj_native.parse_obj_file(path)
    with open(path) as fh:
        v, f = tobj.parse_obj(fh.read())
    assert np.array_equal(vn, v) and np.array_equal(fn, f)
    assert obj_native.parse_obj_file(str(tmp_path / "missing.obj")) is None


def test_validate_rejects_broken_trees():
    centers, bmin, bmax = tbvh.triangle_bounds(*_soup(40, 5))
    host = tbvh.build_bvh(centers, bmin, bmax)
    broken = dataclasses.replace(host, prim_indices=host.prim_indices[::-1].copy())
    with pytest.raises(ValueError, match="contain"):
        tbvh.validate(broken, bmin, bmax)
    shrunk = dataclasses.replace(host, bmax=host.bmax - 1.0)
    with pytest.raises(ValueError, match="contain"):
        tbvh.validate(shrunk, bmin, bmax)
    with pytest.raises(ValueError, match="zero primitives"):
        tbvh.build_bvh(centers[:0], bmin[:0], bmax[:0])


def test_collect_aabbs_by_depth_matches_jax():
    centers, bmin, bmax = tbvh.triangle_bounds(*_soup(64, 9))
    host = tbvh.build_bvh(centers, bmin, bmax)
    jhost = jbvh.build_bvh(centers, bmin, bmax)
    got, want = host.collect_aabbs_by_depth(), jhost.collect_aabbs_by_depth()
    assert len(got) == len(want) == host.max_depth() + 1 == jhost.max_depth() + 1
    assert got[0].shape == (1, 6)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ["rabbit", "mesh_demo"])
def test_attach_bvh_matches_jax(name):
    """Leaf-ordered triangles and the device tree equal the JAX package's."""
    js, _ = getattr(jbuiltin, name)()
    ts, _ = getattr(tbuiltin, name)(device="cpu")
    for k in ("tri_v0", "tri_v1", "tri_v2", "tri_mat"):
        assert np.array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)))
    for k in ("first", "count", "bmin", "bmax"):
        assert np.array_equal(getattr(ts.bvh, k).numpy(), np.asarray(getattr(js.bvh, k)))
    assert ts.bvh.max_leaf == js.bvh.max_leaf
    assert ts.bvh.builder == ("native" if get_lib() is not None else "numpy")


def _bvh_pair(n, seed):
    js, ts = _scenes(n, seed)
    return jbvh.attach_bvh(js), tbvh.attach_bvh(ts)


@pytest.mark.parametrize("n,seed", [(257, 3), (150, 21)])
def test_traversal_matches_jax_and_brute_force(n, seed):
    js, ts = _bvh_pair(n, seed)
    o, d = _rays(256, seed + 2)
    jt, ji = jtrav.closest_hit_bvh(js, js.bvh, jnp.asarray(o), jnp.asarray(d),
                                   1e-3, np.inf)
    tt, ti = ttrav.closest_hit_bvh(ts, ts.bvh, torch.from_numpy(o),
                                   torch.from_numpy(d), 1e-3, float("inf"))
    jt, ji, tt, ti = np.asarray(jt), np.asarray(ji), tt.numpy(), ti.numpy()
    assert (ti == ji).mean() >= 0.999
    hit = (ti == ji) & (ji >= 0)
    assert np.allclose(tt[hit], jt[hit], rtol=1e-6, atol=0)
    bt, bi = tint.closest_hit_triangles(torch.from_numpy(o), torch.from_numpy(d),
                                        ts.tri_v0, ts.tri_v1, ts.tri_v2, 1e-3,
                                        float("inf"))
    assert np.array_equal(bi.numpy(), ti)
    assert (ti >= 0).mean() > 0.1
    janyh = np.asarray(jtrav.any_hit_bvh(js, js.bvh, jnp.asarray(o),
                                         jnp.asarray(d), 1e-3, np.inf))
    tany = ttrav.any_hit_bvh(ts, ts.bvh, torch.from_numpy(o), torch.from_numpy(d),
                             1e-3, float("inf")).numpy()
    assert np.array_equal(tany, janyh) and np.array_equal(tany, ti >= 0)


def test_closest_hit_scene_walks_the_bvh_on_the_cpu():
    """A BVH scene's search on the CPU (the traversal) gives the hits of
    the same scene without the tree (the brute force)."""
    _, ts = _scenes(100, 7)
    tb = tbvh.attach_bvh(ts)
    flat = dataclasses.replace(tb, bvh=None)
    o, d = (torch.from_numpy(a) for a in _rays(64, 11))
    a = tint.intersect_scene(flat, Ray(o, d), 1e-3, float("inf"))
    b = tint.intersect_scene(tb, Ray(o, d), 1e-3, float("inf"))
    assert torch.equal(a.prim, b.prim) and torch.equal(a.t, b.t)


def test_intersect_aabb_matches_jax():
    o, d = _rays(64, 4)
    d[:4, 1] = 0.0  # rays parallel to a slab
    r = np.random.default_rng(6)
    lo = r.uniform(-2, 1, (64, 3)).astype(np.float32)
    hi = lo + r.uniform(0, 2, (64, 3)).astype(np.float32)
    hi[::5, 2] = lo[::5, 2]  # flat boxes
    want = np.asarray(jint.intersect_aabb(*(jnp.asarray(a) for a in (o, d, lo, hi)),
                                          0.0, np.inf))
    got = tint.intersect_aabb(*(torch.from_numpy(a) for a in (o, d, lo, hi)), 0.0,
                              float("inf")).numpy()
    assert np.array_equal(got, want) and 0 < got.mean() < 1


def test_convert_carries_the_bvh():
    js, _ = jbuiltin.mesh_demo(subdiv=1)
    d = {k: np.asarray(getattr(js, k)) for k in (
        "tri_v0", "tri_v1", "tri_v2", "tri_mat", "sph_center", "sph_radius",
        "sph_mat", "pln_normal", "pln_d", "pln_mat")}
    for k in ("albedo", "emission", "ior", "kind"):
        d[f"materials.{k}"] = np.asarray(getattr(js.materials, k))
    no_bvh = convert.scene_from_numpy(d, "cpu")
    assert no_bvh.bvh is None
    for k in ("first", "count", "bmin", "bmax"):
        d[f"bvh.{k}"] = np.asarray(getattr(js.bvh, k))
    d["bvh.max_leaf"] = js.bvh.max_leaf
    ts = convert.scene_from_numpy(d, "cpu")
    tb, _ = tbuiltin.mesh_demo(subdiv=1, device="cpu")
    for k in ("first", "count", "bmin", "bmax"):
        assert torch.equal(getattr(ts.bvh, k), getattr(tb.bvh, k))
    assert ts.bvh.depth == tb.bvh.depth and ts.bvh.max_leaf == tb.bvh.max_leaf
    assert torch.equal(ts.tri_v0, tb.tri_v0)


def test_pack_bvh_pads_boxes_and_keeps_ids():
    ts, _ = tbuiltin.mesh_demo(subdiv=2, device="cpu")
    nodes = tpk.pack_bvh(ts)
    bvh = ts.bvh
    assert nodes.shape == (bvh.num_nodes, len(tpk.NODE_FIELDS))
    bmin = torch.minimum(torch.minimum(ts.tri_v0, ts.tri_v1), ts.tri_v2)
    bmax = torch.maximum(torch.maximum(ts.tri_v0, ts.tri_v1), ts.tri_v2)
    eps = (np.float32(1e-4) * bmax.max().numpy() - np.float32(1e-4) * bmin.min().numpy()
           + np.float32(1e-6))
    assert tpk.bvh_eps(ts).item() == pytest.approx(float(eps), rel=1e-6)
    assert torch.equal(nodes[:, 0:3], bvh.bmin - tpk.bvh_eps(ts))
    assert torch.equal(nodes[:, 3:6], bvh.bmax + tpk.bvh_eps(ts))
    ints = nodes[:, 6:8].contiguous().view(torch.int32)
    assert torch.equal(ints[:, 0], bvh.first) and torch.equal(ints[:, 1], bvh.count)
    deep = dataclasses.replace(ts, bvh=dataclasses.replace(bvh, depth=tpk.BVH_STACK))
    with pytest.raises(ValueError, match="stack"):
        tpk.pack_bvh(deep)


# The builtin trees by name: the small ones, and the deepest the scenes
# reach, mesh_demo(5)'s and terrain_demo(225)'s.
TREES = {"rabbit": ("rabbit", {}), "mesh_demo": ("mesh_demo", {}),
         "terrain_demo": ("terrain_demo", dict(n=40)),
         "mesh_demo(5)": ("mesh_demo", dict(subdiv=5)),
         "terrain_demo(225)": ("terrain_demo", dict(n=225))}


@pytest.mark.parametrize("name", list(TREES))
def test_builtin_trees_fit_the_walk(name):
    """The mesh builtins' attached trees fit the kernels' stack, and
    validate holds for them over the leaf-ordered triangles."""
    maker, kw = TREES[name]
    ts, _ = getattr(tbuiltin, maker)(device="cpu", **kw)
    assert 0 < ts.bvh.depth < tpk.BVH_STACK
    host = ts.bvh.host_view()
    assert host.max_depth() == ts.bvh.depth
    _, bmin, bmax = tbvh.triangle_bounds(
        *(x.numpy() for x in (ts.tri_v0, ts.tri_v1, ts.tri_v2)))
    tbvh.validate(host, bmin, bmax)
