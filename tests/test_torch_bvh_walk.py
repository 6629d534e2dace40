"""The redesigned BVH walk of K1's and B3's BVH forms (csrc/bvh_walk.cuh)
on the CPU: its triangle rows and its any-hit occlusion searches.

* ``pack_walk``'s [T,16] rows and its material side table are a
  rearrangement of ``pack_fwd``'s [T,17] rows: put back, they give those
  rows exactly (rabbit, mesh_demo(3), a small terrain); ``pack_tree``
  carries them with ``pack_bvh``'s nodes, as ``PathTracer.tree``.
* An occlusion search answers whether the ray hits anything, and the
  kernels stop it at its first hit: ``traverse._walk(any_hit=True)`` (the
  reference's intersect_bvh_any, intersection.glsl:417-463), after the
  spheres and planes, finds a hit exactly where the closest-hit search of
  the BVH forms (``_search_tris_last``) returns a family >= 0, on the AO
  probe rays, Appel shadow rays and Whitted shadow rays of a 24x16 rabbit
  and mesh_demo(3) frame (mesh_demo(3)'s floor plane occludes many of
  them).

The kernels themselves run only on the card (tests/test_torch_cuda.py
holds them bit for bit against the plain versions and B5's binary walk).
"""

import pytest
import torch

from rvpt_tpu_torch import FilmConfig
from rvpt_tpu_torch.ops import pathkernel as tpk
from rvpt_tpu_torch.ops import traverse as ttrav
from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays
from rvpt_tpu_torch.scene import builtin


def _scene(name, cfg):
    if name == "rabbit":
        return builtin.rabbit(aspect=cfg.aspect, device="cpu")
    if name == "terrain_demo":
        return builtin.terrain_demo(40, aspect=cfg.aspect, device="cpu")
    return builtin.mesh_demo(3, aspect=cfg.aspect, device="cpu")


@pytest.mark.parametrize("name", ["rabbit", "mesh_demo", "terrain_demo"])
def test_walk_rows_round_trip_to_pack_fwd(name):
    scene, _ = _scene(name, FilmConfig(24, 16))
    tables, counts = tpk.pack_fwd(scene)
    t = counts[0]
    walk = tpk.pack_walk(tables, counts)
    nf = len(tpk.WALK_FIELDS)
    assert nf == 16 and walk.shape == ((nf + 1) * t,) and walk.is_contiguous()
    rows, mat = walk[:nf * t].reshape(t, nf), walk[nf * t:]
    fwd = tables[:len(tpk.TRI_FIELDS) * t].reshape(t, len(tpk.TRI_FIELDS))
    back = torch.stack([mat if f == "mat" else rows[:, tpk.WALK_FIELDS.index(f)]
                        for f in tpk.TRI_FIELDS], dim=1)
    assert torch.equal(back, fwd)
    # The first float4 of a row is what the t-first reject reads.
    assert tpk.WALK_FIELDS[:4] == ("nx", "ny", "nz", "v0n")
    assert torch.equal(mat, scene.tri_mat.to(torch.float32))
    tree = tpk.pack_tree(scene, tables, counts)
    assert torch.equal(tree.rows, walk) and torch.equal(tree.nodes, tpk.pack_bvh(scene))
    pt = tpk.PathTracer(scene)
    assert isinstance(pt.tree, tpk.WalkTree)
    assert torch.equal(pt.tree.rows, walk) and pt.tree.nodes is pt.nodes
    assert tpk.PathTracer(builtin.cornell_box(device="cpu")[0]).tree is None


def _occlusion_searches(scene, cam, cfg):
    """The occlusion searches of a frame, as the plain versions run them
    with the BVH forms' search: AO's 4 probes (mode 5), Appel's shadow ray
    (mode 6) and Whitted's shadow rays (4 bounces) -> [(kind, o3, d3,
    live)]."""
    pixel, xs, ys = _pixel_grid(cfg, "cpu")
    ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, 1, 0)
    pt = tpk.PathTracer(scene)
    rays = pt._rays(ray.origin, ray.direction)
    found = []
    for mode, kind in ((5, "probe"), (6, "shadow")):
        calls = []
        tpk.primary_plain(pt.tables, pt.counts, pixel, 1, 16, mode, 4, None,
                          tris_last=True, rays=rays,
                          on_search=lambda o3, d3, live=None: calls.append((o3, d3, live)))
        found += [(kind, *c) for c in calls[1:]]
    calls = []
    tpk.trace_plain(pt.tables, pt.counts, pixel, 1, 16, 4, "standard", rays=rays,
                    integ="whitted", tris_last=True,
                    on_search=lambda o3, d3, live=None: calls.append((o3, d3, live)))
    found += [("whitted", *c) for c in calls[1::2]]  # bounce, shadow, bounce, ...
    return pt, found


@pytest.mark.parametrize("name", ["rabbit", "mesh_demo"])
def test_any_hit_walk_matches_closest_hit(name):
    cfg = FilmConfig(24, 16)
    scene, cam = _scene(name, cfg)
    pt, searches = _occlusion_searches(scene, cam, cfg)
    tri, sph, pln, _ = tpk._unpack_fwd(pt.tables, pt.counts, tri_rows=True)
    kinds = {kind for kind, *_ in searches}
    assert kinds == {"probe", "shadow", "whitted"}
    blocked = {"plane": 0, "walk": 0, "rays": 0}
    for kind, o3, d3, live in searches:
        closest = tpk._search_tris_last(tri, sph, pln, *o3, *d3, pt.mint, live)
        want = (closest[5] >= 0) & live
        seed = tpk._search_plain([], sph, pln, *o3, *d3, pt.mint)
        origin, direction = torch.stack(o3, 1), torch.stack(d3, 1)
        _, _, walk_hit = ttrav._walk(scene, scene.bvh, origin, direction, pt.mint,
                                     tpk._BIG, any_hit=True)
        got = ((seed[5] >= 0) | walk_hit) & live
        assert torch.equal(got, want), (kind, int((got != want).sum()))
        blocked["rays"] += int(live.sum())
        blocked["plane"] += int(((seed[5] == 2) & live).sum())
        blocked["walk"] += int((walk_hit & (seed[5] < 0) & live).sum())
    assert blocked["walk"] > 0
    if name == "mesh_demo":
        assert blocked["plane"] > 0
