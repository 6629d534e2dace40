"""The CUDA kernels of rvpt_tpu_torch (K1 path_kernel with its Kajiya,
Whitted and Cook forms, K2 bwd_kernel, B8 closest_hit, B3 primary_kernel,
B4 hart_kernel, K1's and B3's BVH forms (B3's with rays passed in too)
and their records (K1's hits-only collect instance too), the big-mesh
route's one launch per frame against B5's per-bounce route (the
redesigned walk of K1 and B3 against B5's binary walk, on mesh_demo(3),
rabbit and a soup with a sphere and a plane), the redesigned walk's
counting instance against the binary walk's, B5
bigmesh_kernel with its collect instance, B6 bigmesh_hart, B7
replay_lookup's gather and segment sum, K1's stats counting instance and
its cluster scan against the parent's full triangle test)
against their plain PyTorch versions, and the CLI, on the card.  Every
test here needs an NVIDIA card and skips without one.  This file imports
no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Bars: K1 >= 99.5% of pixel channels within 1e-4 (the
tests/test_megakernel.py bar), its records (family, index) equal on
>= 99.5% of ray-bounces and fields >= 99.5% within 1e-4; K2 per-ray o/d
cotangents, in units of g's scale, >= 99.5% within rtol 1e-4, atol 1e-6
over all entries and over the non-zero ones, and table columns within
rtol 1e-3, atol 1e-7 (sums over rays in another order); B8 index equal on
>= 99.9% of rays, t within rtol 1e-5 where they agree; B3 (every mode) and
K1's Whitted/Cook forms >= 99.5% of pixel channels within 1e-4, B4 >= 99%
(the tests/test_megakernel.py bars); the BVH forms and B5 >= 99.5% of
channels within 1e-4, B6 >= 99% of live lanes (tests/test_bigmesh_modes.py),
on the mesh builtins and on a random soup with a sphere, a plane, mirror
and dielectric triangles; the BVH-form records and B5's hit records bit for
bit, as are B3's rays-in form, K1's hits-only records, the row forms of
K1 and B3 (every integrator, collect instance, mode and camera model, on
the Cornell box, sphere_plane and 600- and 1,000-triangle soups) and the
big-mesh route against B5's; B7's gather bit for bit, its segment sum within rtol 1e-5, atol 1e-5
of the float64 sum; the mesh fwd+bwd gradients within rtol 1e-3, atol
1e-6 (in units of their scale) of autograd through kajiya_from_hits on the
same records; the stats counters equal per tile, the radiance and records
of the counting instance bit for bit those of the launch without it.  The kernels are
built with --fmad=false and round like the plain versions' unfused ops, so
they usually agree exactly.
"""

import dataclasses

import pytest
import torch

from rvpt_tpu_torch import FilmConfig, RenderSettings
from rvpt_tpu_torch.models import camera as tcam
from rvpt_tpu_torch.ops import pathkernel as tpk
from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays, render_sample_fast_chw
from rvpt_tpu_torch.scene import builtin
from rvpt_tpu_torch.scene.scene import SceneBuilder

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _share(got, want):
    return torch.isclose(got, want, rtol=1e-4, atol=1e-4).float().mean().item()


def _kernel_and_plain(scene, cam, cfg, dev, gen_rays, bounces=3, style="standard"):
    pt = tpk.PathTracer(scene)
    pixel, xs, ys = _pixel_grid(cfg, dev)
    ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, 2, 0)
    comps = tuple(c.contiguous() for c in (
        ray.origin[:, 0], ray.origin[:, 1], ray.origin[:, 2],
        ray.direction[:, 0], ray.direction[:, 1], ray.direction[:, 2]))
    cam_params = tpk.camera_params(cam, cfg)
    kw = dict(rays=None if gen_rays else comps, cam_params=cam_params,
              cam_mode=cam.mode, jitter_salt=0)
    got = tpk.launch_path_kernel(pt.tables, pt.counts, pixel, cfg.num_pixels, 2,
                                 16, bounces, style, **kw)
    want = tpk.trace_plain(pt.tables, pt.counts, pixel, 2, 16, bounces, style, **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("gen_rays", [False, True])
@pytest.mark.parametrize("mode", [tcam.PINHOLE, tcam.ORTHO, tcam.SPHERICAL])
@pytest.mark.parametrize("scene_name", ["cornell_box", "sphere_plane"])
def test_kernel_matches_plain(dev, scene_name, mode, gen_rays):
    cfg = FilmConfig(width=320, height=180)
    scene, cam = getattr(builtin, scene_name)(aspect=cfg.aspect, device=dev)
    cam = dataclasses.replace(cam, mode=mode)
    got, want = _kernel_and_plain(scene, cam, cfg, dev, gen_rays)
    assert torch.isfinite(got).all()
    share = _share(got, want)
    assert share >= 0.995, f"only {share:.4%} of pixel channels match"


@pytest.mark.parametrize("style", ["reference", "standard"])
def test_kernel_deep_paths_and_styles(dev, style):
    """12 bounces, past the JAX kernel's 8-bounce group split."""
    cfg = FilmConfig(width=160, height=90)
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)
    got, want = _kernel_and_plain(scene, cam, cfg, dev, True, bounces=12,
                                  style=style)
    share = _share(got, want)
    assert share >= 0.995, f"only {share:.4%} of pixel channels match"


def test_kernel_single_family_scenes(dev):
    """Triangles only, and one sphere with no materials at all."""
    b = SceneBuilder()
    m = b.add_material(albedo=(0.5, 0.5, 0.5))
    b.add_triangle((-5, -5, 3), (5, -5, 3), (0, 8, 3), m)
    tri_only = b.build(dev)
    b2 = SceneBuilder()
    b2.add_sphere((0, 0, 4), 1.0, 0)
    no_mats = b2.build(dev)
    cfg = FilmConfig(width=64, height=32)
    cam = tcam.Camera.create(fov=90.0, aspect=cfg.aspect, device=dev)
    for scene in (tri_only, no_mats):
        got, want = _kernel_and_plain(scene, cam, cfg, dev, True)
        assert torch.isfinite(got).all()
        assert _share(got, want) >= 0.995


def test_fast_route_counts_launches_and_matches_cpu(dev):
    """render_sample_fast_chw on the card: one launch per AA sample, and the
    film agrees with the CPU plain version of the same frame."""
    cfg = FilmConfig(width=64, height=32)
    st = RenderSettings(max_bounces=3, aa=2, style="standard")
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)
    cpu_scene, cpu_cam = builtin.cornell_box(aspect=cfg.aspect, device="cpu")
    before = tpk.launch_path_kernel.launches
    got = render_sample_fast_chw(scene, cam, st, cfg, 4)
    assert tpk.launch_path_kernel.launches == before + 2
    want = render_sample_fast_chw(cpu_scene, cpu_cam, st, cfg, 4)
    assert _share(got.cpu(), want) >= 0.995


def test_kernel_rejects_bad_inputs(dev):
    cfg = FilmConfig(width=8, height=4)
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)
    pt = tpk.PathTracer(scene)
    big = torch.zeros(8 * 7500, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="shared-memory"):
        tpk.launch_path_kernel(big, (0, 0, 0, 7500), None, 32, 0, 16, 2,
                               "standard", cam_params=tpk.camera_params(cam, cfg))
    with pytest.raises(ValueError, match="cam_params"):
        tpk.launch_path_kernel(pt.tables, pt.counts, None, 32, 0, 16, 2, "standard")
    with pytest.raises(ValueError, match="pixel"):
        tpk.launch_path_kernel(pt.tables, pt.counts,
                               torch.arange(32, dtype=torch.int32, device=dev),
                               32, 0, 16, 2, "standard",
                               cam_params=tpk.camera_params(cam, cfg))


# ---------------------------------------------------------------------------
# The training path: K1 records, K2, B8
# ---------------------------------------------------------------------------


def _soup(dev, n_tri, seed=7):
    """A seeded triangle soup in front of the camera, with a light, a glass
    sphere and a floor plane (every family and material kind)."""
    import numpy as np

    r = np.random.default_rng(seed)
    b = SceneBuilder()
    mats = [b.add_material(albedo=(0.7, 0.6, 0.5)),
            b.add_material(albedo=(0.9, 0.9, 0.9), kind=1),
            b.add_material(albedo=(0.95, 0.95, 0.95), kind=2, ior=1.4)]
    light = b.add_material(albedo=(0.0, 0.0, 0.0), emission=(5.0, 5.0, 5.0))
    size = 2.0 * (12.0 / n_tri) ** 0.5
    for k in range(n_tri):
        c = r.uniform(-2, 2, 3)
        c[2] += 4.0
        b.add_triangle(tuple(c), tuple(c + r.normal(0, size, 3)),
                       tuple(c + r.normal(0, size, 3)), mats[k % 3])
    b.add_sphere((0.0, 2.5, 4.0), 0.8, light)
    b.add_sphere((0.5, -0.5, 3.5), 0.5, mats[2])
    b.add_plane((0.0, 1.0, 0.0), -2.0, mats[0])
    return b.build(dev)


def _rays(scene, cam, cfg, dev):
    pixel, xs, ys = _pixel_grid(cfg, dev)
    ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, 0, 0)
    return pixel, tuple(c.contiguous() for c in (
        ray.origin[:, 0], ray.origin[:, 1], ray.origin[:, 2],
        ray.direction[:, 0], ray.direction[:, 1], ray.direction[:, 2]))


def _record_agreement(got, want):
    hits = (got.hits == want.hits).all(dim=1).float().mean().item()
    fields = torch.isclose(got.fields, want.fields, rtol=1e-4,
                           atol=1e-4).float().mean().item()
    return hits, fields


@pytest.mark.parametrize("gen_rays", [False, True])
@pytest.mark.parametrize("scene_name", ["cornell_box", "soup"])
def test_collect_matches_plain(dev, scene_name, gen_rays):
    """K1 with records: radiance equal to K1 without them, records against
    trace_plain's."""
    cfg = FilmConfig(width=320, height=180)
    if scene_name == "soup":
        scene = _soup(dev, 60)
        cam = tcam.Camera.create(fov=90.0, aspect=cfg.aspect, device=dev)
    else:
        scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)
    pt = tpk.PathTracer(scene)
    pixel, rays = _rays(scene, cam, cfg, dev)
    kw = dict(rays=None if gen_rays else rays,
              cam_params=tpk.camera_params(cam, cfg), cam_mode=cam.mode)
    n = cfg.num_pixels
    got, rec = tpk.launch_path_kernel(pt.tables, pt.counts, pixel, n, 3, 16, 4,
                                      "standard", collect=True, **kw)
    bare = tpk.launch_path_kernel(pt.tables, pt.counts, pixel, n, 3, 16, 4,
                                  "standard", **kw)
    want, wrec = tpk.trace_plain(pt.tables, pt.counts, pixel, 3, 16, 4,
                                 "standard", collect=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, bare)
    assert _share(got, want) >= 0.995
    hits, fields = _record_agreement(rec, wrec)
    assert hits >= 0.995 and fields >= 0.995, (hits, fields)


def _bwd_pair(scene, cam, cfg, dev, style, g_kind):
    import numpy as np

    pt = tpk.PathTracer(scene)
    pixel, rays = _rays(scene, cam, cfg, dev)
    n = cfg.num_pixels
    _, rec = tpk.launch_path_kernel(pt.tables, pt.counts, pixel, n, 3, 16, 4,
                                    style, rays=rays, collect=True)
    scale = 1.0 / (3 * n)  # the mean loss's cotangent
    if g_kind == "mean":
        g = torch.full((n, 3), scale, device=dev)
    else:  # seeded, at the mean loss's scale
        g = torch.from_numpy(np.random.default_rng(1).normal(size=(n, 3))
                             .astype(np.float32) * np.float32(scale)).to(dev)
    tables, counts = tpk.pack_bwd(scene)
    got = tpk.launch_bwd_kernel(tables, counts, rec, pixel, 3, 16, style, g)
    want = tpk.bwd_plain(tables, counts, rec, pixel, 3, 16, style, g)
    torch.cuda.synchronize()
    return got, want, scale


def _assert_bwd_close(got, want, scale, ray_gradient=True):
    """K2's bars; ``ray_gradient`` False for a scene whose paths end on the
    sky after one Lambert hit, where the o and d cotangents are exactly 0
    (held to zero, then)."""
    (gf, go, gd), (wf, wo, wd) = got, want
    for a, b in ((go, wo), (gd, wd)):
        # In units of g's scale (the cotangents are linear in g), over all
        # entries and over the ones the plain version makes non-zero: most
        # are exactly 0, so zeros written by the kernel would pass the first.
        a, b = a / scale, b / scale
        close = torch.isclose(a, b, rtol=1e-4, atol=1e-6)
        nz = b != 0
        if not ray_gradient:
            assert close.all() and not nz.any()
            continue
        assert nz.sum().item() >= 3 * b.shape[0] // 1000, nz.sum().item()
        assert close.float().mean().item() >= 0.995
        assert close[nz].float().mean().item() >= 0.995
    assert torch.isfinite(gf).all()
    assert wf.abs().max() > 0
    torch.testing.assert_close(gf, wf, rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("g_kind", ["mean", "random"])
@pytest.mark.parametrize("style", ["reference", "standard"])
def test_bwd_kernel_matches_plain(dev, style, g_kind):
    cfg = FilmConfig(width=320, height=180)
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)
    _assert_bwd_close(*_bwd_pair(scene, cam, cfg, dev, style, g_kind))


def test_bwd_kernel_1024_triangles(dev):
    """A seeded 1,024-triangle soup: K2 stages past the 48 KB default of
    shared memory (and K1 too); a 1,025-triangle scene is refused by K2
    and takes the SoA replay in make_fast_kajiya."""
    cfg = FilmConfig(width=320, height=180)
    cam = tcam.Camera.create(fov=90.0, aspect=cfg.aspect, device=dev)
    scene = _soup(dev, tpk.MAX_BWD_TRIANGLES)
    _assert_bwd_close(*_bwd_pair(scene, cam, cfg, dev, "standard", "random"))

    from rvpt_tpu_torch.ops.fast_grad import make_fast_kajiya

    big = _soup(dev, tpk.MAX_BWD_TRIANGLES + 1)
    tables, counts = tpk.pack_bwd(big)
    n = 256
    rec = tpk.PathRecord(torch.zeros((2, 13, n), device=dev),
                         torch.full((2, 2, n), -1, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="1024"):
        tpk.launch_bwd_kernel(tables, counts, rec, None, 0, 16, "standard",
                              torch.zeros((n, 3), device=dev))
    pixel, ray = _bigmesh_rays(big, cam, cfg, dev)
    albedo = big.materials.albedo.clone().requires_grad_(True)
    s = dataclasses.replace(big, materials=dataclasses.replace(big.materials,
                                                               albedo=albedo))
    k2 = tpk.launch_bwd_kernel.launches
    out = make_fast_kajiya(big, 16, 2)(s, ray.origin, ray.direction, pixel, 0)
    torch.mean(out).backward()
    torch.cuda.synchronize()
    assert tpk.launch_bwd_kernel.launches == k2
    assert torch.isfinite(albedo.grad).all() and albedo.grad.abs().max() > 0


def _wall_stack(dev, n_tri, n_mat):
    """n_tri big parallel triangles across the whole view, 1e-4 apart in
    depth (the nearest wins every camera ray), triangle k with material
    k % n_mat: Lambert walls whose paths end on the sky."""
    b = SceneBuilder()
    mats = [b.add_material(albedo=(0.2 + 0.7 * k / n_mat, 0.5, 0.9 - 0.7 * k / n_mat))
            for k in range(n_mat)]
    for k in range(n_tri):
        z = 5.0 + 1e-4 * k
        b.add_triangle((-60.0, -40.0, z), (60.0, -40.0, z), (0.0, 60.0, z),
                       mats[k % n_mat])
    return b.build(dev)


def _rows_per_warp(rec, counts, b):
    """Distinct (family, row) keys per warp of 32 consecutive rays among
    the live hits of bounce b, averaged over the warps with any."""
    t, s, _, _ = counts
    fam, idx = rec.hits[b, 0].long(), rec.hits[b, 1].long()
    key = torch.where(fam < 0, -1, idx + torch.where(fam == 1, t, 0)
                      + torch.where(fam == 2, t + s, 0))
    key = key[: key.numel() // 32 * 32].view(-1, 32)
    srt = key.sort(dim=1).values
    distinct = 1 + (srt[:, 1:] != srt[:, :-1]).sum(dim=1) - (srt[:, 0] < 0).long()
    any_hit = (srt >= 0).any(dim=1)
    return distinct[any_hit].double().mean().item()


@pytest.mark.parametrize("case", ["one_row", "own_row", "mixed"])
def test_bwd_kernel_adversarial_warps(dev, case):
    """K2's row groups: every lane of every warp on one table row and one
    material row (a single wall); every lane on its own row (1,024 walls
    and 32 materials, each ray's hit moved to triangle i % 1024); and
    families and rows mixed within each warp (the Cornell record's rays in
    a seeded random order)."""
    import numpy as np

    cfg = FilmConfig(width=320, height=180)
    cam = tcam.Camera.create(fov=90.0, aspect=cfg.aspect, device=dev)
    if case == "one_row":
        scene = _wall_stack(dev, 1, 1)
    elif case == "own_row":
        scene = _wall_stack(dev, tpk.MAX_BWD_TRIANGLES, 32)
    else:
        scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)
    pt = tpk.PathTracer(scene)
    pixel, rays = _rays(scene, cam, cfg, dev)
    n = cfg.num_pixels
    _, rec = tpk.launch_path_kernel(pt.tables, pt.counts, pixel, n, 3, 16, 4,
                                    "standard", rays=rays, collect=True)
    hits = rec.hits.clone()
    if case == "own_row":
        lane_row = (torch.arange(n, device=dev) % tpk.MAX_BWD_TRIANGLES).to(torch.int32)
        hits[:, 1] = torch.where(hits[:, 0] == 0, lane_row, hits[:, 1])
    fields = rec.fields
    if case == "mixed":
        perm = torch.from_numpy(np.random.default_rng(4).permutation(n)).to(dev)
        fields, hits, pixel = fields[:, :, perm], hits[:, :, perm], pixel[perm]
    rec = tpk.PathRecord(fields.contiguous(), hits.contiguous())
    per_warp = _rows_per_warp(rec, pt.counts, 0)
    want_rows = {"one_row": 1.0, "own_row": 32.0}.get(case)
    if want_rows is None:
        assert _rows_per_warp(rec, pt.counts, 1) > 4.0
    else:
        assert per_warp == want_rows
    scale = 1.0 / (3 * n)
    g = torch.from_numpy(np.random.default_rng(2).normal(size=(n, 3))
                         .astype(np.float32) * np.float32(scale)).to(dev)
    tables, counts = tpk.pack_bwd(scene)
    got = tpk.launch_bwd_kernel(tables, counts, rec, pixel, 3, 16, "standard", g)
    want = tpk.bwd_plain(tables, counts, rec, pixel, 3, 16, "standard", g)
    torch.cuda.synchronize()
    _assert_bwd_close(got, want, scale, ray_gradient=case == "mixed")


@pytest.mark.parametrize("bounced", [False, True])
def test_closest_hit_matches_plain(dev, bounced):
    from rvpt_tpu_torch.ops import intersect as tint
    from rvpt_tpu_torch.ops import intersect_pk as tipk

    cfg = FilmConfig(width=320, height=180)
    cam = tcam.Camera.create(fov=90.0, aspect=cfg.aspect, device=dev)
    scene = _soup(dev, 300)
    pixel, xs, ys = _pixel_grid(cfg, dev)
    ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, 0, 0)
    o, d = ray.origin.contiguous(), ray.direction.contiguous()
    if bounced:
        pt = tpk.PathTracer(scene)
        _, rec = pt(pixel, o, d, 0, 16, 2, collect_states=True)
        o = rec.fields[1, 0:3].T.contiguous()
        d = rec.fields[1, 3:6].T.contiguous()
    packed = tipk.pack_triangles(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    t, idx = tipk.launch_closest_hit(o, d, packed, 0.0, float("inf"))
    wt, widx = tint.closest_hit_triangles(o, d, scene.tri_v0, scene.tri_v1,
                                          scene.tri_v2, 0.0, float("inf"))
    torch.cuda.synchronize()
    same = idx == widx
    assert same.float().mean().item() >= 0.999
    assert (widx >= 0).float().mean().item() > 0.05
    torch.testing.assert_close(t[same], wt[same], rtol=1e-5, atol=0.0)


def _b8_edge_case(case, dev):
    """(o, d, v0, v1, v2, mint, maxt) of one of B8's edge cases (the inputs
    of tests/test_torch_edges_b8_stats.py, made here from numpy): duplicate
    triangles (every hit a tie), mint at a hit's t, rays parallel to the
    triangles' planes (dn == 0), a finite maxt, 512 triangles (one chunk)
    and 513 (one row past it, that row the nearest for some rays)."""
    import numpy as np

    from rvpt_tpu_torch.ops import intersect as tint

    def soup(n, seed):
        r = np.random.default_rng(seed)
        c = r.uniform(-2, 2, (n, 3)).astype(np.float32)
        c[:, 2] += 4.0
        size = 2.0 * np.sqrt(12.0 / n)
        return [c, c + r.normal(0, size, (n, 3)).astype(np.float32),
                c + r.normal(0, size, (n, 3)).astype(np.float32)]

    r = np.random.default_rng(1)
    o = r.uniform(-0.5, 0.5, (65536, 3)).astype(np.float32)
    d = r.normal(size=(65536, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    vs = soup(128, 3)
    mint, maxt = 0.0, float("inf")
    if case == "ties":
        vs = [np.concatenate([v[:64], v[:64]]) for v in vs]
    elif case == "parallel":
        z = np.round(vs[0][:, 2])
        for v in vs:
            v[:, 2] = z
        d[: d.shape[0] // 2, 2] = 0.0
    elif case == "maxt":
        maxt = 4.0
    elif case in ("rows512", "rows513"):
        vs = soup(512, 5)
        if case == "rows513":
            near = np.array([[-3.0, -3.0, 1.0], [3.0, -3.0, 1.0], [0.0, 0.5, 1.0]],
                            dtype=np.float32)
            vs = [np.concatenate([v, near[k][None]]) for k, v in enumerate(vs)]
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    vs = [torch.from_numpy(v).to(dev) for v in vs]
    if case == "at_mint":
        t, i = tint.closest_hit_triangles(o, d, *vs, 0.0, maxt)
        mint = float(t[i >= 0][0].item())
    return (o, d, *vs, mint, maxt)


@pytest.mark.parametrize("case", ["ties", "at_mint", "parallel", "maxt", "rows512",
                                  "rows513"])
def test_closest_hit_edges_match_plain(dev, case):
    """B8 (float4 rows, the t-first reject, one stage for a table of up to
    512 rows) against closest_hit_triangles on its edge inputs: the index
    equal on every ray on ties and at the chunk edge, the bar of
    test_closest_hit_matches_plain elsewhere; t and the index of a miss."""
    from rvpt_tpu_torch.ops import intersect as tint
    from rvpt_tpu_torch.ops import intersect_pk as tipk

    o, d, v0, v1, v2, mint, maxt = _b8_edge_case(case, dev)
    t, idx = tipk.launch_closest_hit(o, d, tipk.pack_triangles(v0, v1, v2), mint, maxt)
    wt, widx = tint.closest_hit_triangles(o, d, v0, v1, v2, mint, maxt)
    torch.cuda.synchronize()
    same = idx == widx
    if case in ("ties", "rows512", "rows513"):
        assert torch.equal(idx, widx)
    else:
        assert same.float().mean().item() >= 0.999
    assert (widx >= 0).any()
    torch.testing.assert_close(t[same], wt[same], rtol=1e-5, atol=0.0)
    assert bool(torch.isinf(t[idx < 0]).all()) and bool((t[idx >= 0] > mint).all())
    assert bool((t[idx >= 0] < maxt).all())
    if case == "ties":
        assert bool((idx < 64).all())
    if case == "rows513":
        assert int((idx == 512).sum().item()) > 0


def test_cuda_scene_never_reaches_a_plain_version(dev, monkeypatch):
    """The paired trace, the trainer step, the plain render path and every
    integrator mode on the card, single and split-screen: every kernel's
    launch count rises and no plain version runs."""
    from rvpt_tpu_torch.ops import intersect as tint
    from rvpt_tpu_torch.ops import intersect_pk as tipk
    from rvpt_tpu_torch.render import render_sample_chw
    from rvpt_tpu_torch.train import inverse

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(tpk, "trace_plain", refuse)
    monkeypatch.setattr(tpk, "bwd_plain", refuse)
    monkeypatch.setattr(tpk, "primary_plain", refuse)
    monkeypatch.setattr(tpk, "hart_plain", refuse)
    monkeypatch.setattr(tint, "closest_hit_triangles", refuse)
    cfg = FilmConfig(width=64, height=32)
    st = RenderSettings(max_bounces=3, style="standard")
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)
    target = render_sample_chw(scene, cam, st, cfg, 0)
    k1, k2, b8 = (tpk.launch_path_kernel.launches, tpk.launch_bwd_kernel.launches,
                  tipk.launch_closest_hit.launches)
    assert b8 > 0
    step, opt = inverse.make_train_step(scene, cam, st, cfg, None, target)
    params, opt, loss = step(inverse.trainable_params(scene), opt, 0)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    # one K1 for the stop-gradient buffer, one K1 with records and one K2
    assert tpk.launch_path_kernel.launches == k1 + 2
    assert tpk.launch_bwd_kernel.launches == k2 + 1
    assert tipk.launch_closest_hit.launches == b8
    assert params["materials.albedo"].device.type == "cuda"

    from rvpt_tpu_torch.renderer import Renderer

    split = st.replace(top_left_render_mode=5, top_right_render_mode=7,
                       bottom_left_render_mode=10, bottom_right_render_mode=8)
    kernels = (tpk.launch_path_kernel, tpk.launch_primary_kernel,
               tpk.launch_hart_kernel)
    for settings in [st.replace(**dict.fromkeys(
            ("top_left_render_mode", "top_right_render_mode",
             "bottom_left_render_mode", "bottom_right_render_mode"), m))
            for m in range(11)] + [split]:
        before = [k.launches for k in kernels]
        img = Renderer(scene, cam, settings, cfg).draw()
        torch.cuda.synchronize()
        assert torch.isfinite(img).all()
        assert sum(k.launches for k in kernels) > sum(before)
    # The plain integrators (fast=False) on the card search with B8.
    b8 = tipk.launch_closest_hit.launches
    render_sample_chw(scene, cam, split, cfg, 0)
    torch.cuda.synchronize()
    assert tipk.launch_closest_hit.launches > b8


# ---------------------------------------------------------------------------
# The other integrators: B3, B4, K1's Whitted/Cook forms, split-screen
# ---------------------------------------------------------------------------


def _row_case(scene_name, cfg, dev):
    if scene_name.startswith("soup"):
        scene = _soup(dev, int(scene_name[4:]))
        return scene, tcam.Camera.create(fov=90.0, aspect=cfg.aspect, device=dev)
    return getattr(builtin, scene_name)(aspect=cfg.aspect, device=dev)


@pytest.mark.parametrize("mode", [tcam.PINHOLE, tcam.ORTHO, tcam.SPHERICAL])
@pytest.mark.parametrize("scene_name", ["cornell_box", "sphere_plane", "soup600",
                                        "soup1000"])
def test_row_form_bit_for_bit(dev, scene_name, mode):
    """K1's and B3's row forms (csrc/scene_search.cuh: float4 rows, the
    t-first reject, any-hit occlusion searches) bit for bit the plain
    versions, camera rays made in the kernels: Kajiya, Whitted and Cook,
    the full and hits-only collect instances, B3 in modes 0-6; 600 and
    1,000 triangles (past 48 KB of tables: the opt-in shared memory)."""
    cfg = FilmConfig(width=160, height=90)
    scene, cam = _row_case(scene_name, cfg, dev)
    cam = dataclasses.replace(cam, mode=mode)
    pt = tpk.PathTracer(scene)
    n = cfg.num_pixels
    pix = torch.arange(n, device=dev)
    kw = dict(cam_params=tpk.camera_params(cam, cfg), cam_mode=mode, jitter_salt=0)
    for integ in ("kajiya", "whitted", "cook"):
        got = tpk.launch_path_kernel(pt.tables, pt.counts, None, n, 2, 16, 4,
                                     "standard", integ=integ, **kw)
        want = tpk.trace_plain(pt.tables, pt.counts, pix, 2, 16, 4, "standard",
                               integ=integ, **kw)
        assert torch.equal(got, want), integ
    got, rec = tpk.launch_path_kernel(pt.tables, pt.counts, None, n, 2, 16, 4,
                                      "standard", collect=True, **kw)
    want, wrec = tpk.trace_plain(pt.tables, pt.counts, pix, 2, 16, 4, "standard",
                                 collect=True, **kw)
    assert torch.equal(got, want)
    assert torch.equal(rec.fields, wrec.fields) and torch.equal(rec.hits, wrec.hits)
    _, hits = tpk.launch_path_kernel(pt.tables, pt.counts, None, n, 2, 16, 4,
                                     "standard", collect="hits", **kw)
    assert torch.equal(hits, wrec.hits)
    for m in range(7):
        got = tpk.launch_primary_kernel(pt.tables, pt.counts, None, n, 2, 16, m, 4,
                                        **kw)
        want = tpk.primary_plain(pt.tables, pt.counts, pix, 2, 16, m, 4, **kw)
        assert torch.equal(got, want), f"mode {m}"


def test_row_form_occlusion_rays(dev):
    """The Appel shadow rays of a Cornell frame: the plain any-hit row
    search finds a hit exactly where the closest-hit search does, and B3's
    binary mode on those rays passed in (the kernel's closest-hit row
    search) agrees with both."""
    cfg = FilmConfig(width=160, height=90)
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)
    pt = tpk.PathTracer(scene)
    n = cfg.num_pixels
    kw = dict(cam_params=tpk.camera_params(cam, cfg), cam_mode=cam.mode, jitter_salt=0)
    caught = []
    tpk.primary_plain(pt.tables, pt.counts, torch.arange(n, device=dev), 2, 16, 6, 1,
                      on_search=lambda o3, d3, live=None: caught.append((o3, d3, live)),
                      **kw)
    o3, d3, live = caught[1]
    rays = tuple(c[live].contiguous() for c in (*o3, *d3))
    m = rays[0].numel()
    got = tpk.launch_primary_kernel(pt.tables, pt.counts, None, m, 2, 16, 0, 1,
                                    None, rays=rays)
    tri, sph, pln, _ = tpk._unpack_fwd(pt.tables, pt.counts, tri_rows=True)
    closest = tpk._search_tris_last(tri, sph, pln, *rays, 0.0)[5] >= 0
    hit, _, _ = tpk._any_hit_plain(tri, sph, pln, *rays, 0.0)
    assert torch.equal(hit, closest)
    assert torch.equal(got[0] > 0, closest)


def _tracer_and_camera(scene_name, cfg, dev):
    scene, cam = getattr(builtin, scene_name)(aspect=cfg.aspect, device=dev)
    return tpk.PathTracer(scene), cam, tpk.camera_params(cam, cfg)


@pytest.mark.parametrize("mode", range(7))
@pytest.mark.parametrize("scene_name", ["cornell_box", "sphere_plane"])
def test_primary_kernel_matches_plain(dev, scene_name, mode):
    cfg = FilmConfig(width=320, height=180)
    pt, cam, cp = _tracer_and_camera(scene_name, cfg, dev)
    n = cfg.num_pixels
    got = tpk.launch_primary_kernel(pt.tables, pt.counts, None, n, 3, 16, mode,
                                    4, cp, cam.mode, 0)
    want = tpk.primary_plain(pt.tables, pt.counts,
                             torch.arange(n, device=dev), 3, 16, mode, 4, cp,
                             cam.mode, 0)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    share = _share(got, want)
    assert share >= 0.995, f"mode {mode}: only {share:.4%} of channels match"


def test_primary_kernel_pixel_ids(dev):
    """A split-screen rectangle's pixel ids (the AO probes key their RNG by
    the global id)."""
    from rvpt_tpu_torch.render import _rect_pixels

    cfg = FilmConfig(width=320, height=180)
    pt, cam, cp = _tracer_and_camera("cornell_box", cfg, dev)
    pix = _rect_pixels(40, 130, 100, 300, cfg.width, dev)
    got = tpk.launch_primary_kernel(pt.tables, pt.counts, pix, pix.numel(), 3,
                                    16, 5, 4, cp, cam.mode, 0)
    full = tpk.launch_primary_kernel(pt.tables, pt.counts, None, cfg.num_pixels,
                                     3, 16, 5, 4, cp, cam.mode, 0)
    torch.cuda.synchronize()
    assert torch.equal(got, full[:, pix])


@pytest.mark.parametrize("bounces", [3, 10])
@pytest.mark.parametrize("integ", ["whitted", "cook"])
@pytest.mark.parametrize("scene_name", ["cornell_box", "sphere_plane"])
def test_bounce_integ_kernel_matches_plain(dev, scene_name, integ, bounces):
    cfg = FilmConfig(width=320, height=180)
    pt, cam, cp = _tracer_and_camera(scene_name, cfg, dev)
    n = cfg.num_pixels
    kw = dict(cam_params=cp, cam_mode=cam.mode, jitter_salt=0, integ=integ)
    for style in ("reference", "standard"):
        got = tpk.launch_path_kernel(pt.tables, pt.counts, None, n, 4, 16,
                                     bounces, style, **kw)
        want = tpk.trace_plain(pt.tables, pt.counts,
                               torch.arange(n, device=dev), 4, 16, bounces,
                               style, **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        share = _share(got, want)
        assert share >= 0.995, f"{integ} {style}: only {share:.4%} match"


@pytest.mark.parametrize("scene_name", ["cornell_box", "sphere_plane", "soup"])
def test_hart_kernel_matches_plain(dev, scene_name):
    """Cornell, the scene without triangles (32/31 everywhere, T = 0) and a
    600-triangle soup (two staged chunks per step)."""
    cfg = FilmConfig(width=320, height=180)
    if scene_name == "soup":
        scene = _soup(dev, 600)
        cam = tcam.Camera.create(fov=90.0, aspect=cfg.aspect, device=dev)
        pt, cp = tpk.PathTracer(scene), tpk.camera_params(cam, cfg)
    else:
        pt, cam, cp = _tracer_and_camera(scene_name, cfg, dev)
    n = cfg.num_pixels
    got = tpk.launch_hart_kernel(pt.hart_tables, pt.hart_count, None, n, 1, cp,
                                 cam.mode, 0)
    want = tpk.hart_plain(pt.hart_tables, pt.hart_count,
                          torch.arange(n, device=dev), 1, cp, cam.mode, 0)
    torch.cuda.synchronize()
    share = _share(got, want)
    assert share >= 0.99, f"only {share:.4%} of channels match"
    if pt.hart_count == 0:
        assert (got == 32.0 / 31.0).all()
    else:
        assert got.min() < 1.0  # some marches stopped


def _hart_case(name, cfg, dev):
    """(tracer, camera, camera vector) of a Hart case: a builtin, rabbit (a
    BVH scene of 143 triangles, which takes B4) or a 600-triangle soup
    (two staged chunks)."""
    if name == "soup600":
        scene = _soup(dev, 600)
        cam = tcam.Camera.create(fov=90.0, aspect=cfg.aspect, device=dev)
    else:
        scene, cam = getattr(builtin, name)(aspect=cfg.aspect, device=dev)
    return tpk.PathTracer(scene), cam, tpk.camera_params(cam, cfg)


@pytest.mark.parametrize("scene_name", ["cornell_box", "rabbit", "soup600",
                                        "sphere_plane"])
def test_hart_kernel_bit_for_bit(dev, scene_name):
    """B4 (invariants staged once, skip tests, warm seeds, the escape test)
    is bit for bit hart_plain's full sweep; its counting instance writes
    the same film, finds no skipped triangle below the running minimum and
    no stop after an escape, and counts no launch."""
    cfg = FilmConfig(width=320, height=180)
    pt, cam, cp = _hart_case(scene_name, cfg, dev)
    n = cfg.num_pixels
    pix = torch.arange(n, device=dev)
    got = tpk.launch_hart_kernel(pt.hart_tables, pt.hart_count, pix, n, 2, cp,
                                 cam.mode, 0)
    want = tpk.hart_plain(pt.hart_tables, pt.hart_count, pix, 2, cp, cam.mode, 0)
    launches = tpk.launch_hart_kernel.launches
    counted, work = tpk.count_hart_sweep(pt.hart_tables, pt.hart_count, pix, n, 2,
                                         cp, cam.mode, 0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(counted, got)
    assert tpk.launch_hart_kernel.launches == launches
    assert work["bad"] == 0 and work["late"] == 0, work
    t = pt.hart_count
    assert work["tests"] + work["seeds"] == work["steps"] * t
    assert work["all_face"] + work["all_edge"] == work["parent_steps"] * t
    if t == 0:
        assert (got == 32.0 / 31.0).all()
    else:
        assert got.min() < 1.0  # some marches stopped
        assert work["face"] + work["edge"] < work["parent_steps"] * t


@pytest.mark.parametrize("mode", [5, 7])
def test_kernels_stage_big_tables(dev, mode):
    """A 1,024-triangle soup: B3 (AO) and K1 (Whitted) stage their tables
    past the 48 KB default of shared memory."""
    from rvpt_tpu_torch.render import _trace_mode_kernel

    cfg = FilmConfig(width=160, height=90)
    cam = tcam.Camera.create(fov=90.0, aspect=cfg.aspect, device=dev)
    pt = tpk.PathTracer(_soup(dev, tpk.MAX_BWD_TRIANGLES))
    st = RenderSettings(max_bounces=3, style="standard")
    args = (cam, st, tpk.camera_params(cam, cfg))
    got = _trace_mode_kernel(pt, *args, cfg.num_pixels, 2, 0, mode)
    cpu = tpk.PathTracer(_soup("cpu", tpk.MAX_BWD_TRIANGLES))
    cpu_cam = tcam.Camera.create(fov=90.0, aspect=cfg.aspect, device="cpu")
    want = _trace_mode_kernel(cpu, cpu_cam, st, tpk.camera_params(cpu_cam, cfg),
                              cfg.num_pixels, 2, 0, mode)
    torch.cuda.synchronize()
    share = _share(got.cpu(), want)
    assert share >= 0.995, f"mode {mode}: only {share:.4%} of channels match"


@pytest.mark.parametrize("mode", [9, 5, 10])
def test_display_draws_big_scenes_through_the_kernels(dev, mode):
    """A 1,500-triangle scene, past the backward kernel's 1,024 but within
    the search kernels' shared-memory staging: Renderer.draw launches its
    mode's kernel once (K1 for Kajiya, B3 for AO, B4 for Hart) and agrees
    with the CPU's plain version of the same frame; a scene whose tables
    exceed the staging takes the plain integrator path."""
    from rvpt_tpu_torch.render import _megakernel_eligible
    from rvpt_tpu_torch.renderer import Renderer

    cfg = FilmConfig(width=64, height=36)
    quads = ("top_left_render_mode", "top_right_render_mode",
             "bottom_left_render_mode", "bottom_right_render_mode")
    st = RenderSettings(max_bounces=3, style="standard", **dict.fromkeys(quads, mode))
    cam = tcam.Camera.create(fov=90.0, aspect=cfg.aspect, device=dev)
    scene = _soup(dev, 1500)
    kernel = {9: tpk.launch_path_kernel, 5: tpk.launch_primary_kernel,
              10: tpk.launch_hart_kernel}[mode]
    before = kernel.launches
    img = Renderer(scene, cam, st, cfg).draw()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    cpu_cam = tcam.Camera.create(fov=90.0, aspect=cfg.aspect, device="cpu")
    want = render_sample_fast_chw(_soup("cpu", 1500), cpu_cam, st, cfg, 0)
    assert _share(img.cpu(), want) >= (0.99 if mode == 10 else 0.995)
    assert not _megakernel_eligible(_soup(dev, 4000), st.replace(
        **dict.fromkeys(quads, 9)))


def test_split_screen_draw_launches_each_kernel(dev):
    """Renderer.draw with (AO, Whitted, Hart, Kajiya) quadrants: one B3, one
    B4 and two K1 launches per frame, and the film agrees with the CPU's
    plain versions of the same frame."""
    from rvpt_tpu_torch.renderer import Renderer

    cfg = FilmConfig(width=64, height=32)
    st = RenderSettings(max_bounces=4, style="standard", top_left_render_mode=5,
                        top_right_render_mode=7, bottom_left_render_mode=10,
                        bottom_right_render_mode=9)
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)
    r = Renderer(scene, cam, st, cfg)
    counts = (tpk.launch_primary_kernel.launches, tpk.launch_hart_kernel.launches,
              tpk.launch_path_kernel.launches)
    img = r.draw()
    r.flush()
    assert (tpk.launch_primary_kernel.launches - counts[0],
            tpk.launch_hart_kernel.launches - counts[1],
            tpk.launch_path_kernel.launches - counts[2]) == (1, 1, 2)
    cpu_scene, cpu_cam = builtin.cornell_box(aspect=cfg.aspect, device="cpu")
    want = render_sample_fast_chw(cpu_scene, cpu_cam, st, cfg, 0)
    assert _share(img.cpu(), want) >= 0.995


# ---------------------------------------------------------------------------
# The BVH mesh display path: K1's and B3's BVH forms, B5 and B6
# ---------------------------------------------------------------------------


def _mesh(name, cfg, dev):
    kw = {"mesh_demo2": dict(subdiv=2), "mesh_demo3": dict(subdiv=3)}.get(name, {})
    make = getattr(builtin, "mesh_demo" if name.startswith("mesh_demo") else name)
    return make(aspect=cfg.aspect, device=dev, **kw)


@pytest.mark.parametrize("integ", ["kajiya", "whitted", "cook"])
@pytest.mark.parametrize("scene_name", ["rabbit", "mesh_demo2"])
def test_bvh_form_k1_matches_plain(dev, scene_name, integ):
    cfg = FilmConfig(width=320, height=180)
    scene, cam = _mesh(scene_name, cfg, dev)
    pt = tpk.PathTracer(scene)
    assert pt.bvh_form
    cp = tpk.camera_params(cam, cfg)
    kw = dict(cam_params=cp, cam_mode=cam.mode, jitter_salt=0, integ=integ)
    before = tpk.launch_path_kernel.launches
    got = tpk.launch_path_kernel(pt.tables, pt.counts, None, cfg.num_pixels, 2, 16,
                                 8, "standard", tree=pt.tree, **kw)
    pix = torch.arange(cfg.num_pixels, device=dev)
    want = tpk.trace_plain(pt.tables, pt.counts, pix, 2, 16, 8, "standard",
                           tris_last=True, **kw)
    torch.cuda.synchronize()
    assert tpk.launch_path_kernel.launches == before + 1
    assert torch.isfinite(got).all()
    share = _share(got, want)
    assert share >= 0.995, f"only {share:.4%} of pixel channels match"


@pytest.mark.parametrize("mode", range(7))
def test_bvh_form_b3_matches_plain(dev, mode):
    cfg = FilmConfig(width=320, height=180)
    scene, cam = _mesh("mesh_demo2", cfg, dev)
    pt = tpk.PathTracer(scene)
    cp = tpk.camera_params(cam, cfg)
    got = tpk.launch_primary_kernel(pt.tables, pt.counts, None, cfg.num_pixels, 1,
                                    16, mode, 4, cp, cam.mode, 0, tree=pt.tree)
    pix = torch.arange(cfg.num_pixels, device=dev)
    want = tpk.primary_plain(pt.tables, pt.counts, pix, 1, 16, mode, 4, cp,
                             cam.mode, 0, tris_last=True)
    torch.cuda.synchronize()
    share = _share(got, want)
    assert share >= 0.995, f"mode {mode}: only {share:.4%} of channels match"


def _bigmesh_rays(scene, cam, cfg, dev):
    pixel, xs, ys = _pixel_grid(cfg, dev)
    ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, 2, 0)
    return pixel, ray


def test_bigmesh_kernel_matches_plain(dev):
    """B5's bounce instance, 6 bounces of mesh_demo(3) from the same state
    each time, and its search-only instance on the last state (dead lanes
    included)."""
    cfg = FilmConfig(width=320, height=180)
    scene, cam = _mesh("mesh_demo3", cfg, dev)
    bt = tpk.BigMeshTracer(scene)
    pixel, ray = _bigmesh_rays(scene, cam, cfg, dev)
    start = tpk._start_state(bt._rays(ray.origin, ray.direction), "kajiya")
    state = torch.stack([*start[:15], start[15].to(torch.float32)])
    for b in range(6):
        got = tpk.launch_bigmesh_kernel(bt.tables, bt.counts, bt.nodes, pixel,
                                        state, 2, 16 + 4 * b)
        want = tpk.bigmesh_bounce_plain(bt.tables, bt.counts, pixel, state, 2,
                                        16 + 4 * b)
        torch.cuda.synchronize()
        share = _share(got, want)
        assert share >= 0.995, f"bounce {b}: only {share:.4%} match"
        dead = state[15] == 0
        assert torch.equal(got[:, dead], state[:, dead])
        state = want
    assert 0 < int(state[15].sum()) < cfg.num_pixels
    packed = torch.stack([*state[:6], state[15]]).contiguous()
    w, i = tpk.launch_bigmesh_kernel(bt.tables, bt.counts, bt.nodes, None, packed,
                                     0, 0, search_only=True)
    ww, wi = tpk.bigmesh_search_plain(bt.tables, bt.counts, state[:6].unbind(0),
                                      state[15] > 0)
    torch.cuda.synchronize()
    assert (i == wi).all(dim=0).float().mean().item() >= 0.995
    assert _share(w, ww) >= 0.995
    assert (i[:, state[15] == 0] == -1).all()


def test_bigmesh_hart_matches_plain(dev):
    cfg = FilmConfig(width=320, height=180)
    scene, cam = _mesh("mesh_demo3", cfg, dev)
    bt = tpk.BigMeshTracer(scene)
    _, ray = _bigmesh_rays(scene, cam, cfg, dev)
    p = (ray.origin + 2.5 * ray.direction).T.contiguous()
    live = torch.arange(cfg.num_pixels, device=dev) % 3 != 0
    got = tpk.launch_bigmesh_hart(bt.hart_tables, bt.hart_count, bt.nodes, p,
                                  live.to(torch.float32))
    want = tpk.bigmesh_distance_plain(bt.hart_tables, bt.hart_count, p, live)
    torch.cuda.synchronize()
    share = _share(got[live], want[live])
    assert share >= 0.99, f"only {share:.4%} of live lanes match"
    assert torch.isinf(got[~live]).all()


def _mixed_soup(n_tri, dev, seed=11):
    """A random soup of Lambert, mirror and dielectric triangles with an
    emissive sphere and a floor plane (the scene of
    tests/test_bigmesh_modes.py, made here from numpy without JAX), so the
    sphere and plane seed of the walk and every scatter branch run."""
    import numpy as np

    from rvpt_tpu_torch.scene.bvh import attach_bvh

    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, size=(n_tri, 3)).astype(np.float32)
    c[:, 2] += 5.0
    e1 = rng.normal(0, 0.4, size=(n_tri, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.4, size=(n_tri, 3)).astype(np.float32)
    b = SceneBuilder()
    lam = b.add_material(albedo=(0.6, 0.5, 0.4))
    mir = b.add_material(albedo=(0.9, 0.9, 0.9), kind=1)
    die = b.add_material(albedo=(1.0, 1.0, 1.0), kind=2, ior=1.5)
    mats = (lam, lam, mir, die)
    for i, (a, v1, v2) in enumerate(zip(c, c + e1, c + e2)):
        b.add_triangle(tuple(a), tuple(v1), tuple(v2), mats[i % 4])
    light = b.add_material(albedo=(0, 0, 0), emission=(4, 4, 4))
    b.add_sphere((0.0, 6.0, 2.0), 1.0, light)
    b.add_plane((0.0, 1.0, 0.0), -3.5, lam)
    scene = attach_bvh(b.build(dev))
    cam = builtin.sphere_plane(aspect=320 / 180, device=dev)[1]
    return scene, cam


@pytest.mark.parametrize("integ", ["kajiya", "whitted", "cook"])
def test_soup_bvh_form_k1_matches_plain(dev, integ):
    """K1's BVH form on a 600-triangle soup with a sphere, a plane, mirror
    and dielectric triangles."""
    cfg = FilmConfig(width=320, height=180)
    scene, cam = _mixed_soup(600, dev)
    pt = tpk.PathTracer(scene)
    assert pt.bvh_form and scene.num_spheres == 1 and scene.num_planes == 1
    kw = dict(cam_params=tpk.camera_params(cam, cfg), cam_mode=cam.mode,
              jitter_salt=0, integ=integ)
    got = tpk.launch_path_kernel(pt.tables, pt.counts, None, cfg.num_pixels, 2, 16,
                                 6, "standard", tree=pt.tree, **kw)
    pix = torch.arange(cfg.num_pixels, device=dev)
    want = tpk.trace_plain(pt.tables, pt.counts, pix, 2, 16, 6, "standard",
                           tris_last=True, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and want.mean() > 0
    share = _share(got, want)
    assert share >= 0.995, f"only {share:.4%} of pixel channels match"


@pytest.mark.parametrize("mode", range(7))
def test_soup_bvh_form_b3_matches_plain(dev, mode):
    cfg = FilmConfig(width=320, height=180)
    scene, cam = _mixed_soup(600, dev)
    pt = tpk.PathTracer(scene)
    cp = tpk.camera_params(cam, cfg)
    got = tpk.launch_primary_kernel(pt.tables, pt.counts, None, cfg.num_pixels, 1,
                                    16, mode, 4, cp, cam.mode, 0, tree=pt.tree)
    pix = torch.arange(cfg.num_pixels, device=dev)
    want = tpk.primary_plain(pt.tables, pt.counts, pix, 1, 16, mode, 4, cp,
                             cam.mode, 0, tris_last=True)
    torch.cuda.synchronize()
    share = _share(got, want)
    assert share >= 0.995, f"mode {mode}: only {share:.4%} of channels match"


def test_soup_bigmesh_kernels_match_plain(dev):
    """B5's bounce and search-only instances and B6 on a 1,500-triangle
    soup: mirror and dielectric triangles scatter, the sphere and the plane
    win their searches, and the walk's winner agrees with the brute
    force's on every bounce."""
    cfg = FilmConfig(width=320, height=180)
    scene, cam = _mixed_soup(1500, dev)
    bt = tpk.BigMeshTracer(scene)
    pixel, ray = _bigmesh_rays(scene, cam, cfg, dev)
    start = tpk._start_state(bt._rays(ray.origin, ray.direction), "kajiya")
    state = torch.stack([*start[:15], start[15].to(torch.float32)])
    fams, mats = set(), set()
    for b in range(6):
        packed = torch.stack([*state[:6], state[15]]).contiguous()
        w, i = tpk.launch_bigmesh_kernel(bt.tables, bt.counts, bt.nodes, None,
                                         packed, 0, 0, search_only=True)
        ww, wi = tpk.bigmesh_search_plain(bt.tables, bt.counts, state[:6].unbind(0),
                                          state[15] > 0)
        got = tpk.launch_bigmesh_kernel(bt.tables, bt.counts, bt.nodes, pixel,
                                        state, 2, 16 + 4 * b)
        want = tpk.bigmesh_bounce_plain(bt.tables, bt.counts, pixel, state, 2,
                                        16 + 4 * b)
        torch.cuda.synchronize()
        assert (i == wi).all(dim=0).float().mean().item() >= 0.995, f"bounce {b}"
        assert _share(w, ww) >= 0.995, f"bounce {b}: search winners"
        share = _share(got, want)
        assert share >= 0.995, f"bounce {b}: only {share:.4%} match"
        dead = state[15] == 0
        assert torch.equal(got[:, dead], state[:, dead])
        fams |= set(wi[0].unique().tolist())
        mats |= set(ww[4][wi[0] == 0].unique().tolist())
        state = want
    assert fams >= {-1, 0, 1, 2}, f"families hit: {fams}"
    assert mats >= {1.0, 2.0}, f"no mirror or dielectric triangle hit: {mats}"
    p = (ray.origin + 2.5 * ray.direction).T.contiguous()
    live = torch.arange(cfg.num_pixels, device=dev) % 3 != 0
    got = tpk.launch_bigmesh_hart(bt.hart_tables, bt.hart_count, bt.nodes, p,
                                  live.to(torch.float32))
    want = tpk.bigmesh_distance_plain(bt.hart_tables, bt.hart_count, p, live)
    torch.cuda.synchronize()
    assert _share(got[live], want[live]) >= 0.99


def _caterpillar(depth, dev):
    """A BVH scene whose tree is a chain of ``depth`` interior nodes (the
    deepest pack_bvh takes at depth BVH_STACK - 1): interior node k holds
    leaf k (triangle k, at x = k) and interior node k + 1 (triangles k..),
    the last one two leaves.  Triangles are in leaf order."""
    from rvpt_tpu_torch.scene.bvh import Bvh

    b = SceneBuilder()
    mat = b.add_material(albedo=(0.5, 0.5, 0.5))
    for k in range(depth + 1):
        x = float(k)
        b.add_triangle((x, 0.0, 0.0), (x + 0.5, 0.0, 0.0), (x, 0.5, 0.2), mat)
    scene = b.build(dev)
    lo = torch.minimum(torch.minimum(scene.tri_v0, scene.tri_v1), scene.tri_v2)
    hi = torch.maximum(torch.maximum(scene.tri_v0, scene.tri_v1), scene.tri_v2)
    first, count, bmin, bmax = [], [], [], []
    for k in range(depth):  # interior k at 2k, leaf k at 2k + 1
        first += [2 * k + 1, k]
        count += [0, 1]
        bmin += [lo[k:].min(dim=0).values, lo[k]]
        bmax += [hi[k:].max(dim=0).values, hi[k]]
    first.append(depth)
    count.append(1)
    bmin.append(lo[depth])
    bmax.append(hi[depth])
    i32 = dict(dtype=torch.int32, device=dev)
    bvh = Bvh(torch.tensor(first, **i32), torch.tensor(count, **i32),
              torch.stack(bmin), torch.stack(bmax), max_leaf=1, depth=depth)
    return dataclasses.replace(scene, bvh=bvh)


def _march_rays(scene, n_cam, dev, seed=3):
    """Rays for the march: ``n_cam`` from a point above the mesh toward
    random points of its box; then from each 97th triangle's centroid and
    from 0.05 off it (within MARCH_EPS: they stop at step 0 without mint),
    and from far out pointing away (they never stop)."""
    import numpy as np

    r = np.random.default_rng(seed)
    lo = torch.minimum(torch.minimum(scene.tri_v0, scene.tri_v1), scene.tri_v2)
    hi = torch.maximum(torch.maximum(scene.tri_v0, scene.tri_v1), scene.tri_v2)
    lo, hi = lo.min(dim=0).values, hi.max(dim=0).values
    u = torch.from_numpy(r.uniform(size=(n_cam, 3)).astype(np.float32)).to(dev)
    target = lo + u * (hi - lo)
    eye = (lo + hi) / 2 + torch.tensor([0.3, 1.0, -2.0], device=dev) * (hi - lo).norm()
    k = torch.arange(0, scene.num_triangles, 97, device=dev)
    cen = (scene.tri_v0[k] + scene.tri_v1[k] + scene.tri_v2[k]) / 3.0
    near = torch.cat([cen, cen + torch.tensor([0.0, 0.0, 0.05], device=dev)])
    far = (hi + 50.0 * (hi - lo).norm()).expand(64, 3)
    o = torch.cat([eye.expand(n_cam, 3), near, far])
    aim = torch.from_numpy(r.normal(size=(near.shape[0], 3)).astype(np.float32)).to(dev)
    d = torch.cat([target - eye, aim, torch.ones(64, 3, device=dev)])
    d = torch.nn.functional.normalize(d, dim=1)
    return o.T.contiguous(), d.T.contiguous(), near.shape[0]


@pytest.mark.parametrize("mint", [0.0, 1.5])
@pytest.mark.parametrize("scene_name", ["mesh_demo3", "soup", "caterpillar"])
def test_bigmesh_march_matches_plain(dev, scene_name, mint):
    """B6's march instance, the whole Hart march in one launch, against
    bigmesh_march_plain: camera-like rays, lanes dead from the start, rays
    from on or next to a triangle (inside its padded boxes; step 0 without
    mint), rays that never stop, mint > 0, and the deepest tree pack_bvh
    takes; >= 99% of rays on the plain version's step (the B6 bar), one
    launch counted."""
    cfg = FilmConfig(width=320, height=180)
    if scene_name == "mesh_demo3":
        scene, _ = _mesh("mesh_demo3", cfg, dev)
    elif scene_name == "soup":
        scene, _ = _mixed_soup(1500, dev)
    else:
        scene = _caterpillar(tpk.BVH_STACK - 1, dev)
    bt = tpk.BigMeshTracer(scene)
    o, d, n_near = _march_rays(scene, 4000, dev)
    n = o.shape[1]
    live = torch.arange(n, device=dev) % 5 != 1
    before = tpk.launch_bigmesh_march.launches
    got = tpk.launch_bigmesh_march(bt.hart_tables, bt.hart_count, bt.nodes, o, d,
                                   mint, live.to(torch.float32))
    every = tpk.launch_bigmesh_march(bt.hart_tables, bt.hart_count, bt.nodes, o, d,
                                     mint)
    want = tpk.bigmesh_march_plain(bt.hart_tables, bt.hart_count, o, d, mint, live)
    want_every = tpk.bigmesh_march_plain(bt.hart_tables, bt.hart_count, o, d, mint)
    torch.cuda.synchronize()
    assert tpk.launch_bigmesh_march.launches == before + 2
    assert got.dtype == torch.int32 and got.shape == (n,)
    for a, b in ((got, want), (every, want_every)):
        share = (a == b).float().mean().item()
        assert share >= 0.99, f"only {share:.4%} of rays on the plain step"
    assert (got[~live] == tpk.MARCH_ITER).all()
    assert (every[-64:] == tpk.MARCH_ITER).all()
    if mint == 0.0:
        assert (every[n - 64 - n_near:n - 64] == 0).all()
    assert (every < tpk.MARCH_ITER).any()


def test_bigmesh_march_empty_and_trace_hart(dev):
    """No rays launch nothing; trace_hart on the card is the march's steps
    times 1/(MARCH_ITER - 1), in one launch."""
    cfg = FilmConfig(width=160, height=90)
    scene, cam = _mesh("mesh_demo3", cfg, dev)
    bt = tpk.BigMeshTracer(scene)
    empty = torch.zeros(3, 0, device=dev)
    before = tpk.launch_bigmesh_march.launches
    out = tpk.launch_bigmesh_march(bt.hart_tables, bt.hart_count, bt.nodes, empty,
                                   empty)
    assert out.shape == (0,) and tpk.launch_bigmesh_march.launches == before
    pixel, ray = _bigmesh_rays(scene, cam, cfg, dev)
    val = bt.trace_hart(pixel, ray.origin, ray.direction)
    steps = tpk.launch_bigmesh_march(bt.hart_tables, bt.hart_count, bt.nodes,
                                     ray.origin.T.contiguous(),
                                     ray.direction.T.contiguous())
    assert tpk.launch_bigmesh_march.launches == before + 2
    assert torch.equal(val[0], steps.to(torch.float32) * (1.0 / (tpk.MARCH_ITER - 1)))


def test_march_counting_instance(dev):
    """count_hart_march: the steps of the march, the warm-started walk's
    tests (up to each ray's escape) no more than the cold walk's (every
    step), its walks k + 1 for a ray that stops at step k and at most
    MARCH_ITER for one that does not, no ray that stops after its escape,
    the cold walk at step 0 within count_hart_walk's, and no launch
    counted."""
    cfg = FilmConfig(width=160, height=90)
    scene, cam = _mesh("mesh_demo3", cfg, dev)
    bt = tpk.BigMeshTracer(scene)
    _, ray = _bigmesh_rays(scene, cam, cfg, dev)
    o, d = ray.origin.T.contiguous(), ray.direction.T.contiguous()
    launches = tpk.launch_bigmesh_march.launches
    steps, work = tpk.count_hart_march(bt.hart_tables, bt.hart_count, bt.nodes, o, d)
    want = tpk.launch_bigmesh_march(bt.hart_tables, bt.hart_count, bt.nodes, o, d)
    assert torch.equal(steps, want)
    assert tpk.launch_bigmesh_march.launches == launches + 1
    assert 0 < work["warm_box"] < work["cold_box"]
    assert 0 < work["warm_tri"] <= work["cold_tri"]
    assert work["late"] == 0  # no ray stops after its escape
    ran = steps.long() + 1
    stopped = steps < tpk.MARCH_ITER
    assert int(ran[stopped].sum()) <= work["walks"]
    assert work["walks"] <= int(ran.clamp(max=tpk.MARCH_ITER).sum())
    _, one = tpk.count_hart_march(bt.hart_tables, bt.hart_count, bt.nodes, o, d,
                                  live=(torch.arange(o.shape[1], device=dev) < 0)
                                  .to(torch.float32))
    assert one == dict.fromkeys(work, 0)
    # One step: the cold walk of the march's first step is count_hart_walk's.
    live = torch.ones(o.shape[1], dtype=torch.bool, device=dev)
    box, tri = tpk.count_hart_walk(bt.hart_tables, bt.hart_count, bt.nodes, o, live)
    assert box <= work["cold_box"] and tri <= work["cold_tri"]


@pytest.mark.parametrize("scene_name", ["mesh_demo3", "soup"])
def test_redesigned_walk_counts(dev, scene_name):
    """count_walk, the redesigned walk's counting instance: its
    closest-hit search visits exactly the nodes and leaves of the binary
    walk (count_bvh_walk), lane for lane; it opens every row the binary
    walk tests and tests at most those in full; its occlusion search does
    no more than the closest-hit search; no work on lanes that are not
    live; no launch counted."""
    cfg = FilmConfig(width=320, height=180)
    if scene_name == "soup":
        scene, cam = _mixed_soup(1500, dev)
    else:
        scene, cam = _mesh(scene_name, cfg, dev)
    pt = tpk.PathTracer(scene)
    _, ray = _bigmesh_rays(scene, cam, cfg, dev)
    rays = tuple(c.contiguous() for c in (*ray.origin.T, *ray.direction.T))
    n = cfg.num_pixels
    live = torch.arange(n, device=dev) % 3 != 0
    before = tpk.launch_primary_kernel.launches
    old = tpk.count_bvh_walk(pt.tables, pt.counts, pt.nodes, rays, live, lanes=True)
    new = tpk.count_walk(pt.tables, pt.counts, pt.tree, rays, live)
    occ = tpk.count_walk(pt.tables, pt.counts, pt.tree, rays, live,
                         any_hit=True)
    torch.cuda.synchronize()
    assert tpk.launch_primary_kernel.launches == before
    assert old.shape == (3, n) and new.shape == occ.shape == (4, n)
    assert torch.equal(new[[0, 1, 3]], old)
    assert (new[2] <= new[1]).all() and (new[2] < new[1]).any()
    assert (occ <= new).all() and (occ[0] < new[0]).any()
    assert not new[:, ~live].any() and not occ[:, ~live].any()
    assert (new[0, live] >= 1).all()


def test_walk_counting_instances(dev):
    """count_bvh_walk and count_hart_walk, the kernels' counting instances
    for the bounds: no work on lanes that are not live, at least the root
    on every live lane, a fraction of the brute force's triangle tests, no
    launch counted, and the timed instances' results unchanged beside
    them."""
    cfg = FilmConfig(width=320, height=180)
    scene, cam = _mixed_soup(1500, dev)
    bt = tpk.BigMeshTracer(scene)
    _, ray = _bigmesh_rays(scene, cam, cfg, dev)
    rays = tuple(c.contiguous() for c in (*ray.origin.T, *ray.direction.T))
    n = cfg.num_pixels
    live = torch.arange(n, device=dev) % 2 == 0
    launches = (tpk.launch_bigmesh_kernel.launches, tpk.launch_bigmesh_hart.launches)
    assert tpk.count_bvh_walk(bt.tables, bt.counts, bt.nodes, rays,
                              torch.zeros_like(live)) == (0, 0)
    box, tri = tpk.count_bvh_walk(bt.tables, bt.counts, bt.nodes, rays, live)
    box_all, tri_all = tpk.count_bvh_walk(bt.tables, bt.counts, bt.nodes, rays,
                                          torch.ones_like(live))
    assert int(live.sum()) <= box < box_all and 0 < tri < tri_all
    assert tri_all < n * scene.num_triangles // 10
    p = (ray.origin + 2.5 * ray.direction).T.contiguous()
    hbox, htri = tpk.count_hart_walk(bt.hart_tables, bt.hart_count, bt.nodes, p, live)
    assert int(live.sum()) <= hbox and 0 < htri < int(live.sum()) * scene.num_triangles // 4
    assert (tpk.launch_bigmesh_kernel.launches,
            tpk.launch_bigmesh_hart.launches) == launches
    w, i = tpk.launch_bigmesh_kernel(
        bt.tables, bt.counts, bt.nodes, None,
        torch.stack([*rays, live.to(torch.float32)]).contiguous(), 0, 0,
        search_only=True)
    ww, wi = tpk.bigmesh_search_plain(bt.tables, bt.counts, rays, live)
    torch.cuda.synchronize()
    assert torch.equal(i, wi) and _share(w, ww) >= 0.995


@pytest.mark.parametrize("mode", [9, 3, 5, 7, 8, 10])
def test_bigmesh_draw_launches_and_matches_cpu(dev, mode, monkeypatch):
    """Renderer.draw on mesh_demo(3): Kajiya, Whitted and Cook launch K1's
    BVH form once per frame, modes 0-6 B3's, Hart B6's march (and its
    per-step instance never); B5 never runs; no plain version runs on the
    card; the film agrees with the CPU's plain route of the same frame."""
    from rvpt_tpu_torch.renderer import Renderer

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    cfg = FilmConfig(width=64, height=36)
    quads = ("top_left_render_mode", "top_right_render_mode",
             "bottom_left_render_mode", "bottom_right_render_mode")
    st = RenderSettings(max_bounces=3, style="standard", **dict.fromkeys(quads, mode))
    scene, cam = _mesh("mesh_demo3", cfg, dev)
    cpu_scene, cpu_cam = _mesh("mesh_demo3", cfg, "cpu")
    want = render_sample_fast_chw(cpu_scene, cpu_cam, st, cfg, 0)
    for name in ("bigmesh_bounce_plain", "bigmesh_search_plain",
                 "bigmesh_distance_plain", "bigmesh_march_plain", "trace_plain",
                 "primary_plain"):
        monkeypatch.setattr(tpk, name, refuse)
    counters = (tpk.launch_bigmesh_kernel, tpk.launch_bigmesh_hart,
                tpk.launch_bigmesh_march, tpk.launch_path_kernel,
                tpk.launch_primary_kernel)
    counts = [k.launches for k in counters]
    r = Renderer(scene, cam, st, cfg)
    assert isinstance(r.tracer, tpk.BigMeshTracer)
    img = r.draw()
    r.flush()
    ran = tuple(k.launches - c for k, c in zip(counters, counts))
    expect = ((0, 0, 1, 0, 0) if mode == 10 else (0, 0, 0, 1, 0) if mode >= 7
              else (0, 0, 0, 0, 1))
    assert ran == expect
    share = _share(img.cpu(), want)
    assert share >= (0.99 if mode == 10 else 0.995), f"{share:.4%}"


def test_bvh_scene_draw_takes_the_bvh_form(dev):
    """rabbit (143 triangles) draws through K1's BVH form, one launch."""
    from rvpt_tpu_torch.renderer import Renderer

    cfg = FilmConfig(width=128, height=64)
    scene, cam = builtin.rabbit(aspect=cfg.aspect, device=dev)
    st = RenderSettings(max_bounces=8)
    r = Renderer(scene, cam, st, cfg)
    assert r.tracer.bvh_form
    before = tpk.launch_path_kernel.launches
    img = r.draw()
    r.flush()
    assert tpk.launch_path_kernel.launches == before + 1
    cpu_scene, cpu_cam = builtin.rabbit(aspect=cfg.aspect, device="cpu")
    want = render_sample_fast_chw(cpu_scene, cpu_cam, st, cfg, 0)
    assert _share(img.cpu(), want) >= 0.995


@pytest.mark.parametrize("mode", range(7))
@pytest.mark.parametrize("scene_name", ["mesh_demo3", "soup"])
def test_b3_rays_in_matches_plain(dev, scene_name, mode):
    """B3's BVH form with the rays passed in (the big-mesh route's) against
    primary_plain(rays=...), bit for bit, on mesh_demo(3) and the
    1,500-triangle soup (AO with 4 probes)."""
    cfg = FilmConfig(width=320, height=180)
    if scene_name == "soup":
        scene, cam = _mixed_soup(1500, dev)
    else:
        scene, cam = _mesh(scene_name, cfg, dev)
    pt = tpk.PathTracer(scene)
    pixel, rays = _rays(scene, cam, cfg, dev)
    before = tpk.launch_primary_kernel.launches
    got = tpk.launch_primary_kernel(pt.tables, pt.counts, pixel, cfg.num_pixels, 1,
                                    16, mode, 4, None, tree=pt.tree,
                                    rays=rays)
    want = tpk.primary_plain(pt.tables, pt.counts, pixel, 1, 16, mode, 4, None,
                             tris_last=True, rays=rays)
    torch.cuda.synchronize()
    assert tpk.launch_primary_kernel.launches == before + 1
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), f"mode {mode}: {_share(got, want):.4%} within 1e-4"


@pytest.mark.parametrize("mode", range(10))
@pytest.mark.parametrize("scene_name", ["mesh_demo3", "rabbit", "soup"])
def test_bigmesh_one_launch_matches_the_b5_route(dev, scene_name, mode):
    """BigMeshTracer's one-launch route (K1's or B3's BVH form: the
    redesigned walk, any-hit on AO's, Appel's and Whitted's occlusion
    searches) on mesh_demo(3), rabbit and the 1,500-triangle soup with its
    sphere and floor plane at 320x180 x 4, standard, against the
    per-bounce route composed of B5's launches (BigMeshTracer.search and
    .bounce, the binary walk) and against its plain composition, bit for
    bit."""
    from rvpt_tpu_torch.ops.bigmesh_route import per_bounce, plain_bounce

    cfg = FilmConfig(width=320, height=180)
    if scene_name == "soup":
        scene, cam = _mixed_soup(1500, dev)
    elif scene_name == "rabbit":
        scene, cam = builtin.rabbit(aspect=cfg.aspect, device=dev)
    else:
        scene, cam = _mesh(scene_name, cfg, dev)
    bt = tpk.BigMeshTracer(scene)
    pixel, ray = _bigmesh_rays(scene, cam, cfg, dev)
    nrays = 4 if mode == 5 else 1
    args = (2, 16, 4, "standard", nrays)
    counts = (tpk.launch_path_kernel.launches, tpk.launch_primary_kernel.launches,
              tpk.launch_bigmesh_kernel.launches)
    got = bt.trace_mode(pixel, ray.origin, ray.direction, 2, mode, salt_base=16,
                        max_bounces=4, style="standard", nrays=nrays)
    ran = (tpk.launch_path_kernel.launches - counts[0],
           tpk.launch_primary_kernel.launches - counts[1],
           tpk.launch_bigmesh_kernel.launches - counts[2])
    rays = bt._rays(ray.origin, ray.direction)
    b5 = per_bounce(bt, mode, pixel, rays, *args, search=bt.search, bounce=bt.bounce)
    plain = per_bounce(bt, mode, pixel, rays, *args, bounce=plain_bounce(bt))
    torch.cuda.synchronize()
    assert ran == ((0, 1, 0) if mode < 7 else (1, 0, 0))
    assert torch.isfinite(got).all() and got.max() > 0
    assert torch.equal(got, b5), f"mode {mode}: {_share(got, b5):.4%} within 1e-4"
    assert torch.equal(got, plain), f"mode {mode}: {_share(got, plain):.4%}"


# ---------------------------------------------------------------------------
# The mesh gradient path: B7 (gather, segment sum), K1's BVH-form records,
# B5's collect instance, the paired trace on meshes
# ---------------------------------------------------------------------------


def _lookup_inputs(dev, t_rows, n, c, seed, ids="uniform"):
    import numpy as np

    r = np.random.default_rng(seed)
    tabs = torch.from_numpy(r.standard_normal((c, t_rows)).astype(np.float32)).to(dev)
    if ids == "hot":  # nine rays in ten on row 0, as misses in the replay
        idx = np.where(r.random(n) < 0.9, 0, r.integers(0, t_rows, n))
    elif ids == "clustered":
        # 1,024-ray blocks drawn from 512-row windows (hot rows), the last
        # block partial.
        bases = r.integers(0, max(t_rows - 512, 1), -(-n // 1024))
        idx = np.concatenate([r.integers(b, min(b + 512, t_rows), 1024)
                              for b in bases])[:n]
    else:
        idx = r.integers(0, t_rows, n)
    idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
    g = torch.from_numpy(r.standard_normal((c, n)).astype(np.float32)).to(dev)
    return tabs, idx, g


@pytest.mark.parametrize("ids", ["uniform", "clustered", "hot"])
@pytest.mark.parametrize("t_rows", [1282, 20482, 140000])
def test_replay_lookups_match_plain(dev, t_rows, ids):
    """B7's gather is bit for bit with gather_plain; its segment sum within
    rtol 1e-5, atol 1e-5 of segsum_plain's float64 sum (g of scale 1), and
    two calls agree within that bar (float64 atomics in no fixed order)."""
    from rvpt_tpu_torch.ops import replay_soa as trs

    n = (1 << 18) + 77
    tabs, idx, g = _lookup_inputs(dev, t_rows, n, 10, t_rows, ids)
    launches = (trs.launch_gather.launches, trs.launch_segsum.launches)
    got = trs.gather(tabs, idx)
    s1 = trs.segsum(idx, g[:9].contiguous(), t_rows)
    s2 = trs.segsum(idx, g[:9].contiguous(), t_rows)
    want = trs.gather_plain(tabs, idx)
    ref = trs.segsum_plain(idx, g[:9], t_rows)
    torch.cuda.synchronize()
    assert (trs.launch_gather.launches, trs.launch_segsum.launches) == (
        launches[0] + 1, launches[1] + 2)
    assert torch.equal(got, want)
    torch.testing.assert_close(s1, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s1, s2, rtol=1e-5, atol=1e-5)
    assert ref.abs().max() > 0


def test_replay_lookup_group_on_the_card(dev):
    """_lookup_group past 64 rows: one gather forward, one segment sum
    backward for the differentiated columns only; an empty index."""
    from rvpt_tpu_torch.ops import replay_soa as trs

    tabs, idx, g = _lookup_inputs(dev, 5597, 2348, 5, 3)
    leaves = [t.clone().requires_grad_(k < 4) for k, t in enumerate(tabs)]
    before = (trs.launch_gather.launches, trs.launch_segsum.launches)
    out = trs._lookup_group(leaves, idx.long(), n_diff=4)
    grads = torch.autograd.grad(sum((o * w).sum() for o, w in zip(out, g)),
                                leaves[:4])
    torch.cuda.synchronize()
    assert (trs.launch_gather.launches, trs.launch_segsum.launches) == (
        before[0] + 1, before[1] + 1)
    ref = trs.segsum_plain(idx, g[:4], 5597)
    for k in range(4):
        torch.testing.assert_close(grads[k], ref[k], rtol=1e-5, atol=1e-5)
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    assert trs.gather(tabs, empty).shape == (5, 0)
    assert not trs.segsum(empty, torch.zeros(5, 0, device=dev), 5597).any()


# The segment sum's blocks (csrc/replay_lookup.cu): SEG_RAYS rays each, a
# table of SEG_SLOTS rows while C <= 14; C = NO_TABLE columns of float64
# sums do not fit one row in SEG_SMEM, and ONE_SLOT fit exactly one.
SEG_RAYS, SEG_SLOTS = 4096, 1024
NO_TABLE, ONE_SLOT = 14_464, 14_463


def _segsum_ids(case, n, t_rows, dev):
    import numpy as np

    r = np.random.default_rng(13)
    ray = np.arange(n, dtype=np.int64)
    if case == "one_row":
        idx = np.full(n, t_rows // 2)
    elif case == "distinct":
        idx = r.permutation(t_rows)[:n]
    elif case == "out_of_range":
        idx = r.integers(-50, t_rows + 50, n)
    elif case in ("span_in", "span_out"):
        # each block's chunk spans exactly SEG_SLOTS rows (no two collide
        # in its table) or one more (two share a slot)
        span = SEG_SLOTS + (case == "span_out")
        idx = (ray // SEG_RAYS) * 3 * span + ray % span
    elif case == "overflow":  # more rows per chunk than the table holds
        idx = (ray // SEG_RAYS) * 50 * SEG_SLOTS + r.integers(0, 50 * SEG_SLOTS, n)
    else:
        idx = r.integers(0, t_rows, n)
    return torch.from_numpy(idx.astype(np.int32) % np.int32(t_rows)
                            if case not in ("out_of_range",) else
                            idx.astype(np.int32)).to(dev)


@pytest.mark.parametrize("case,n_col,t_rows,n", [
    ("one_row", 9, 50, 100_003),
    ("distinct", 9, 70_000, 70_000),
    ("out_of_range", 9, 5000, 300_001),
    ("span_in", 9, 500_000, 300_000),
    ("span_out", 9, 500_000, 300_000),
    ("overflow", 9, 2_000_000, 300_000),
    ("random", NO_TABLE, 300, 5000),
    ("random", ONE_SLOT, 300, 5000),
    ("random", 1, 5000, 300_000),
    ("random", 10, 5000, 300_000),
    ("random", 17, 5000, 300_000),
    ("one_row", 9, 1, 50_000),
    ("random", 9, 140_000, 2_073_600),
    ("random", 9, 5000, 0),
])
def test_segsum_block_table_matches_plain(dev, case, n_col, t_rows, n):
    """B7's segment sum (block tables in shared memory) against
    segsum_plain's float64 sum of the in-range ids, within rtol 1e-5, atol
    1e-5 (g of scale 1), twice: every id on one row, every id distinct, ids
    out of range, a chunk span just inside and just outside the table, more
    rows per chunk than it holds, so many columns that no table fits or
    one row does, C = 1, 10 and 17 (more columns than one register pass),
    T = 1, T > 131,072, n = 0."""
    import numpy as np

    from rvpt_tpu_torch.ops import replay_soa as trs

    idx = _segsum_ids(case, n, t_rows, dev)
    g = torch.from_numpy(np.random.default_rng(n_col).standard_normal((n_col, n))
                         .astype(np.float32)).to(dev)
    before = trs.launch_segsum.launches
    s1 = trs.launch_segsum(idx, g, t_rows)
    s2 = trs.launch_segsum(idx, g, t_rows)
    ok = (idx >= 0) & (idx < t_rows)
    ref = trs.segsum_plain(idx[ok], g[:, ok].contiguous(), t_rows)
    torch.cuda.synchronize()
    assert trs.launch_segsum.launches == before + 2
    assert s1.shape == (n_col, t_rows) and s1.dtype == torch.float32
    torch.testing.assert_close(s1, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s2, ref, rtol=1e-5, atol=1e-5)
    if n and case != "out_of_range":
        assert ref.abs().max() > 0
    if case == "out_of_range":
        assert not ok.all() and ok.any()


@pytest.mark.parametrize("n", [1, SEG_RAYS - 1, SEG_RAYS + 1, 1_000_003])
def test_segsum_partial_blocks(dev, n):
    """A last block of fewer than SEG_RAYS rays (and a partial last round
    of the block's threads) gives the float64 sum."""
    import numpy as np

    from rvpt_tpu_torch.ops import replay_soa as trs

    t_rows = 140_000
    base = np.arange(n, dtype=np.int64) * t_rows // n
    r = np.random.default_rng(n)
    idx = torch.from_numpy(np.clip(base + r.integers(-300, 300, n), 0, t_rows - 1)
                           .astype(np.int32)).to(dev)
    g = torch.from_numpy(r.standard_normal((9, n)).astype(np.float32)).to(dev)
    got = trs.launch_segsum(idx, g, t_rows)
    ref = trs.segsum_plain(idx, g, t_rows)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_soup_bvh_form_records_match_plain(dev):
    """K1's BVH-form collect instance on the 600-triangle soup: records
    bit-identical to trace_plain's, the radiance that of the display
    instance."""
    cfg = FilmConfig(width=320, height=180)
    scene, cam = _mixed_soup(600, dev)
    pt = tpk.PathTracer(scene)
    pixel, rays = _rays(scene, cam, cfg, dev)
    n = cfg.num_pixels
    got, rec = tpk.launch_path_kernel(pt.tables, pt.counts, pixel, n, 2, 16, 6,
                                      "standard", rays=rays, collect=True,
                                      tree=pt.tree)
    bare = tpk.launch_path_kernel(pt.tables, pt.counts, pixel, n, 2, 16, 6,
                                  "standard", rays=rays, tree=pt.tree)
    want, wrec = tpk.trace_plain(pt.tables, pt.counts, pixel, 2, 16, 6, "standard",
                                 rays=rays, collect=True, tris_last=True)
    torch.cuda.synchronize()
    assert torch.equal(got, bare)
    assert torch.equal(rec.hits, wrec.hits)
    assert torch.equal(rec.fields, wrec.fields)
    assert _share(got, want) >= 0.995
    assert set(rec.hits[:, 0].unique().tolist()) >= {-1, 0, 1, 2}


@pytest.mark.parametrize("scene_name", ["cornell_box", "soup600", "mesh_demo3"])
def test_hits_only_collect_matches_plain(dev, scene_name):
    """K1's hits-only collect instance (row form on the Cornell box, BVH
    form on the 600-triangle soup and on mesh_demo(3), a big mesh), 8
    bounces, rays in: hits bit for bit those of trace_plain(collect=True)
    and of the full collect instance's rec_i, the radiance that of the
    launch without records (and within the K1 bar of trace_plain's)."""
    cfg = FilmConfig(width=320, height=180)
    if scene_name == "soup600":
        scene, cam = _mixed_soup(600, dev)
    elif scene_name == "cornell_box":
        scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)
    else:
        scene, cam = _mesh(scene_name, cfg, dev)
    pt = tpk.PathTracer(scene)
    assert pt.bvh_form == (scene_name != "cornell_box")
    pixel, rays = _rays(scene, cam, cfg, dev)
    n = cfg.num_pixels
    kw = dict(rays=rays, tree=pt.tree)
    got, hits = tpk.launch_path_kernel(pt.tables, pt.counts, pixel, n, 2, 16, 8,
                                       "standard", collect="hits", **kw)
    full, rec = tpk.launch_path_kernel(pt.tables, pt.counts, pixel, n, 2, 16, 8,
                                       "standard", collect=True, **kw)
    bare = tpk.launch_path_kernel(pt.tables, pt.counts, pixel, n, 2, 16, 8,
                                  "standard", **kw)
    want, wrec = tpk.trace_plain(pt.tables, pt.counts, pixel, 2, 16, 8, "standard",
                                 rays=rays, collect=True, tris_last=pt.bvh_form)
    torch.cuda.synchronize()
    assert hits.shape == (8, 2, n) and hits.dtype == torch.int32
    assert torch.equal(got, bare) and torch.equal(got, full)
    assert torch.equal(hits, rec.hits) and torch.equal(hits, wrec.hits)
    assert _share(got, want) >= 0.995
    assert (hits[:, 0] == 0).any() and (hits[:, 0] == -1).any()
    rgb, (fams, idxs) = pt.trace(pixel, rays[:3], rays[3:], 2, 16, 8,
                                 style="standard", collect_hits=True)
    assert torch.equal(fams, hits[:, 0].long()) and torch.equal(idxs, hits[:, 1].long())
    if pt.bvh_form:  # B5's per-bounce route: its collect instance, bounce by bounce
        bt = tpk.BigMeshTracer(scene)
        start = tpk._start_state(rays, "kajiya")
        state = torch.stack([*start[:15], start[15].to(torch.float32)])
        b5 = []
        for b in range(8):
            state, h = bt.bounce(pixel, state, 2, 16 + 4 * b, collect=True)
            b5.append(h)
        assert torch.equal(hits, torch.stack(b5))


def test_soup_bigmesh_collect_matches_plain(dev):
    """B5's collect instance on the 1,500-triangle soup, 6 bounces: the
    state of the bounce instance and hit records bit-identical to
    bigmesh_bounce_plain(collect=True)'s, -1 on dead lanes."""
    cfg = FilmConfig(width=320, height=180)
    scene, cam = _mixed_soup(1500, dev)
    bt = tpk.BigMeshTracer(scene)
    pixel, ray = _bigmesh_rays(scene, cam, cfg, dev)
    start = tpk._start_state(bt._rays(ray.origin, ray.direction), "kajiya")
    state = torch.stack([*start[:15], start[15].to(torch.float32)])
    for b in range(6):
        got, hits = tpk.launch_bigmesh_kernel(bt.tables, bt.counts, bt.nodes, pixel,
                                              state, 2, 16 + 4 * b, collect=True)
        bare = tpk.launch_bigmesh_kernel(bt.tables, bt.counts, bt.nodes, pixel,
                                         state, 2, 16 + 4 * b)
        want, whits = tpk.bigmesh_bounce_plain(bt.tables, bt.counts, pixel, state, 2,
                                               16 + 4 * b, collect=True)
        torch.cuda.synchronize()
        assert torch.equal(got, bare), f"bounce {b}"
        assert torch.equal(hits, whits), f"bounce {b}"
        assert torch.equal(got, want), f"bounce {b}"
        assert (hits[:, state[15] == 0] == -1).all()
        state = want


def _mesh_step(scene, cam, cfg, dev, backward="auto"):
    """Value and gradients of the mean image over albedo, emission and the
    vertices through make_fast_kajiya, and autograd through
    kajiya_from_hits on the records of the same forward."""
    from rvpt_tpu_torch.core.types import Ray
    from rvpt_tpu_torch.ops.fast_grad import kajiya_from_hits, make_fast_kajiya
    from rvpt_tpu_torch.train import inverse

    pixel, ray = _bigmesh_rays(scene, cam, cfg, dev)
    trace = make_fast_kajiya(scene, 16, 8, style="standard", backward=backward)
    groups = ("albedo", "emission", "vertices")

    def grads(run):
        p = {k: x.detach().clone().requires_grad_(True)
             for k, x in inverse.trainable_params(scene, groups).items()}
        out = run(inverse.apply_params(scene, p))
        return out, torch.autograd.grad(torch.mean(out), list(p.values()))

    out, got = grads(lambda s: trace(s, ray.origin, ray.direction, pixel, 3))
    if tpk.is_bigmesh(scene):
        _, (fams, idxs) = tpk.BigMeshTracer(scene).trace(
            pixel, ray.origin, ray.direction, 3, 16, 8, style="standard",
            collect_hits=True)
    else:
        pt = tpk.PathTracer(scene)
        _, rec = pt.trace(pixel, ray.origin, ray.direction, 3, 16, 8,
                          style="standard", collect_states=True)
        fams, idxs = pt.hits_from_record(rec)
    # The reference in float64 (autograd's transpose of indexing sums each
    # row's duplicates one by one).
    p = {k: x.detach().double().requires_grad_(True)
         for k, x in inverse.trainable_params(scene, groups).items()}
    ref = kajiya_from_hits(inverse.apply_params(scene, p),
                           Ray(ray.origin.double(), ray.direction.double()), pixel, 3,
                           16, fams, idxs, "standard")
    want = [w.float() for w in torch.autograd.grad(torch.mean(ref), list(p.values()))]
    return out, got, want


@pytest.mark.parametrize("name,backward", [("mesh_demo3", "auto"), ("rabbit", "auto"),
                                           ("rabbit", "soa")])
def test_mesh_fwd_bwd_matches_replay_autograd(dev, name, backward):
    """The paired trace on meshes at 320x180 x 8: mesh_demo(3) through K1's
    hits-only collect instance (one launch, none of B5) and the SoA replay
    (8 gathers and 7 segment sums: the vertices of the last bounce's hit
    shape only the next ray, which the image never sees),
    rabbit through K1's BVH-form records and K2 (auto) or the SoA replay;
    gradients within rtol 1e-3, atol 1e-6 (in units of the gradient's
    scale) of autograd through kajiya_from_hits in float64 on the same
    records."""
    from rvpt_tpu_torch.ops import replay_soa as trs

    cfg = FilmConfig(width=320, height=180)
    scene, cam = _mesh(name, cfg, dev)
    counters = (tpk.launch_bigmesh_kernel, tpk.launch_path_kernel,
                tpk.launch_bwd_kernel, trs.launch_gather, trs.launch_segsum)
    before = [k.launches for k in counters]
    out, got, want = _mesh_step(scene, cam, cfg, dev, backward)
    torch.cuda.synchronize()
    ran = [k.launches - b for k, b in zip(counters, before)]
    soa = backward == "soa" or name != "rabbit"
    if name == "rabbit":
        assert ran[1] >= 1 and ran[2] == (0 if soa else 1)
    else:
        # one K1 launch in the step, one for the reference's records
        assert ran[0] == 0 and ran[1] == 2 and ran[2] == 0
    if soa and scene.num_triangles > trs._LOOKUP_UNROLL:
        assert ran[3] >= 8 and ran[4] == 7
    for g, w in zip(got, want):
        scale = w.abs().max()
        assert scale > 0 and torch.isfinite(g).all()
        torch.testing.assert_close(g / scale, w / scale, rtol=1e-3, atol=1e-6)


def test_mesh_step_never_reaches_a_plain_version(dev, monkeypatch):
    """A mesh_demo(3) training step on the card launches K1's BVH form
    (the stop-gradient trace, then the hits-only collect instance) and B7,
    and no B5; no plain version runs."""
    from rvpt_tpu_torch.ops import replay_soa as trs
    from rvpt_tpu_torch.train import inverse

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    cfg = FilmConfig(width=64, height=36)
    st = RenderSettings(max_bounces=3, style="standard")
    scene, cam = _mesh("mesh_demo3", cfg, dev)
    target = render_sample_fast_chw(scene, cam, st, cfg, 0)
    for mod, name in ((tpk, "bigmesh_bounce_plain"), (tpk, "trace_plain"),
                      (trs, "gather_plain"), (trs, "segsum_plain")):
        monkeypatch.setattr(mod, name, refuse)
    counters = (tpk.launch_bigmesh_kernel, tpk.launch_path_kernel,
                trs.launch_gather, trs.launch_segsum)
    before = [k.launches for k in counters]
    step, opt = inverse.make_train_step(scene, cam, st, cfg, None, target,
                                        groups=("albedo", "vertices"))
    params, opt, loss = step(inverse.trainable_params(scene, ("albedo", "vertices")),
                             opt, 0)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    # one trace without records, one with hits; 3 gathers and 2 segment
    # sums (the last hit's vertices shape only the next ray)
    assert tuple(k.launches - b for k, b in zip(counters, before)) == (0, 2, 3, 2)


@pytest.mark.parametrize("integ", ["kajiya", "whitted", "cook"])
@pytest.mark.parametrize("name", ["mesh_demo3", "soup", "soup1000"])
def test_stats_instance_matches_plain(dev, name, integ):
    """K1's counting instance (PathTracer.trace(stats=True)) on a film of
    one whole and one partial 8,192-ray tile, camera rays made in the
    kernel: the radiance bit for bit that of the launch without stats, the
    per-tile counters equal to the plain version's (cull_stats_hook, run on
    the card inside debug.interpret_kernels, which launches nothing), and
    with records (Kajiya) the records of the collect instance."""
    from rvpt_tpu_torch.utils import debug

    cfg = FilmConfig(width=256, height=40)
    if name.startswith("soup"):
        scene, cam = _mixed_soup(1000 if name == "soup1000" else 600, dev)
    else:
        scene, cam = builtin.mesh_demo(3, aspect=cfg.aspect, device=dev)
    pt = tpk.PathTracer(scene)
    assert pt.cull is not None
    n = cfg.num_pixels
    kw = dict(gen_rays=True, cam_params=tpk.camera_params(cam, cfg), cam_mode=cam.mode,
              jitter_salt=0, integ=integ)
    rgb, agg = pt.trace(n, None, None, 2, 16, 6, "standard", stats=True, **kw)
    want_rgb = pt.trace(n, None, None, 2, 16, 6, "standard", **kw)
    launches = tpk.launch_path_stats.launches, tpk.launch_path_kernel.launches
    with debug.interpret_kernels():
        plain_rgb, plain = pt.trace(n, None, None, 2, 16, 6, "standard", stats=True, **kw)
    torch.cuda.synchronize()
    assert (tpk.launch_path_stats.launches, tpk.launch_path_kernel.launches) == launches
    assert all(torch.equal(a, b) for a, b in zip(rgb, want_rgb))
    got = torch.stack(agg)
    assert got.shape == (3, 2) and got[0].sum() > 0
    assert torch.equal(got, torch.stack(plain))
    assert _share(torch.stack(rgb), torch.stack(plain_rgb)) >= 0.995
    if integ == "kajiya":
        rgb2, rec, agg2 = pt.trace(n, None, None, 2, 16, 6, "standard", stats=True,
                                   collect_states=True, **kw)
        _, rec0 = pt.trace(n, None, None, 2, 16, 6, "standard", collect_states=True,
                           **kw)
        assert all(torch.equal(a, b) for a, b in zip(rgb2, rgb))
        assert torch.equal(rec.fields, rec0.fields) and torch.equal(rec.hits, rec0.hits)
        assert torch.equal(torch.stack(agg2), got)


@pytest.mark.parametrize("name", ["mesh_demo3", "soup1000"])
def test_stats_scan_matches_the_full_test(dev, name):
    """The counting walk's t-only triangle test against the parent's full
    bvh::test_triangle (``stats_scan``, a small launch that runs both scans
    over every cluster): on the rays of every search of a Kajiya, Whitted
    and Cook trace (the plain version's on_search hook, 6 bounces), the
    running best t agrees in every bit after every cluster, and so does
    every passed-or-not decision."""
    cfg = FilmConfig(width=256, height=40)
    if name == "soup1000":
        scene, cam = _mixed_soup(1000, dev)
    else:
        scene, cam = builtin.mesh_demo(3, aspect=cfg.aspect, device=dev)
    pt = tpk.PathTracer(scene)
    searches = []

    def hook(o3, d3, live=None):
        lanes = (torch.arange(o3[0].numel(), device=dev) if live is None
                 else torch.nonzero(live).squeeze(1))
        searches.append(tuple(c[lanes].contiguous() for c in (*o3, *d3)))

    for integ in ("kajiya", "whitted", "cook"):
        tpk.trace_plain(pt.tables, pt.counts, torch.arange(cfg.num_pixels, device=dev), 2,
                        16, 6, "standard", cam_params=tpk.camera_params(cam, cfg),
                        cam_mode=cam.mode, integ=integ, tris_last=True, on_search=hook)
    before = tpk.stats_scan.launches
    rays = [torch.cat([s[k] for s in searches]) for k in range(6)]
    t_ref, t_new, differ = tpk.stats_scan(pt.tables, pt.counts, pt.tree, pt.cull, rays)
    torch.cuda.synchronize()
    assert tpk.stats_scan.launches == before + 1
    assert rays[0].numel() > cfg.num_pixels
    assert int(differ.sum().item()) == 0
    assert torch.equal(t_ref.view(torch.int32), t_new.view(torch.int32))
    assert bool((t_ref < 3e38).any())


def test_cli_renders_on_the_card_by_default(dev, tmp_path):
    """python -m rvpt_tpu_torch.cli without --device: the card, through
    the kernels (one K1 launch per frame), a checkpoint that resumes."""
    from rvpt_tpu_torch import cli

    tpk.launch_path_kernel.launches = 0
    out, ck = str(tmp_path / "c.png"), str(tmp_path / "c.npz")
    assert cli.main(["--size", "64x32", "--frames", "3", "--bounces", "2", "--out", out,
                     "--checkpoint", ck]) == 0
    assert tpk.launch_path_kernel.launches == 3
    assert cli.main(["--size", "64x32", "--frames", "1", "--bounces", "2", "--out", out,
                     "--resume", ck, "--checkpoint", ck]) == 0
    assert tpk.launch_path_kernel.launches == 4
    import numpy as np

    with np.load(ck) as data:
        assert int(data["['film']/.frame"]) == 4
