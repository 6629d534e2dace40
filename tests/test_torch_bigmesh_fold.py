"""The big-mesh route folded into one launch per frame, on the CPU.

``BigMeshTracer`` runs a big mesh through K1's and B3's BVH forms with the
rays passed in (on the CPU: ``trace_plain(tris_last=True, rays=...)`` and
``primary_plain(tris_last=True, rays=...)``), where it ran B5 one launch per
bounce or search with the shading in PyTorch between launches.  These
tests hold the new route (``BigMeshTracer.trace_mode``, as
``render._trace_mode_bigmesh`` calls it) against that per-bounce
composition (``ops.bigmesh_route.per_bounce``, from
``bigmesh_bounce_plain``, ``bigmesh_search_plain``, ``_shade_plain``,
``_primary_finalize`` and ``_finish_plain``): equal bit for bit (``torch.equal``) in modes 0-9, both styles for 7-9, AO with 4 probes,
on the whole film and on a split-screen quadrant's pixel ids; the hit
records of ``collect_hits`` (K1's hits-only collect instance) equal to
``bigmesh_bounce_plain(collect=True)``'s; and the SoA route's gradients
against JAX's ``make_fast_kajiya`` by tests/test_torch_mesh_grad.py's bar
(rtol 2e-2, atol 1e-5) and against autograd through ``kajiya_from_hits``
(rtol 1e-3, atol 1e-6).

The scene is a 1,500-triangle soup of Lambert, mirror and dielectric
triangles with an emissive sphere and a floor plane (the make of
tests/test_torch_bigmesh.py's soup, built here from numpy), at 32x18 and 3
bounces.  Only the gradient test runs JAX (imported there).
"""

import numpy as np
import pytest
import torch

from rvpt_tpu_torch import FilmConfig, RenderSettings
from rvpt_tpu_torch.ops import pathkernel as tpk
from rvpt_tpu_torch.ops.bigmesh_route import per_bounce, plain_bounce
from rvpt_tpu_torch.render import (_pixel_grid, _rect_pixels, _split_partition,
                                   jittered_camera_rays)
from rvpt_tpu_torch.scene import builtin
from rvpt_tpu_torch.scene.bvh import attach_bvh
from rvpt_tpu_torch.scene.scene import SceneBuilder

W, H, BOUNCES, FRAME, SALT = 32, 18, 3, 5, 16
# A split-screen's quadrants; the bottom-right one's pixel ids are the
# subset the route sees for a quadrant.
SPLIT = RenderSettings(top_left_render_mode=5, top_right_render_mode=7,
                       bottom_left_render_mode=10, bottom_right_render_mode=9,
                       split_ratio=(0.4, 0.6))


def mixed_soup(n_tri, device="cpu", seed=11):
    """A seeded soup of Lambert, mirror and dielectric triangles (every
    scatter branch), an emissive sphere and a floor plane (the walk's
    seed), BVH attached, and a camera looking at it."""
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
    scene = attach_bvh(b.build(device))
    cam = builtin.sphere_plane(aspect=W / H, device=device)[1]
    return scene, cam


@pytest.fixture(scope="module")
def soup():
    scene, cam = mixed_soup(1500)
    assert tpk.is_bigmesh(scene)
    return scene, cam


def _pixels(which):
    cfg = FilmConfig(W, H)
    if which == "film":
        return _pixel_grid(cfg, "cpu")[0]
    (y0, y1, x0, x1), = [r for m, r in _split_partition(cfg, SPLIT) if m == 9]
    assert 0 < y0 and 0 < x0
    return _rect_pixels(y0, y1, x0, x1, W, "cpu")


def _camera_rays(cam, pix):
    cfg = FilmConfig(W, H)
    ray = jittered_camera_rays(cam, cfg, pix, pix % W, pix // W, FRAME, 0)
    return ray.origin, ray.direction


CASES = ([(m, "standard") for m in range(7)]
         + [(m, s) for m in (7, 8, 9) for s in ("reference", "standard")])


@pytest.mark.parametrize("which", ["film", "quadrant"])
@pytest.mark.parametrize("mode,style", CASES)
def test_one_launch_is_the_per_bounce_route(soup, mode, style, which):
    """Each mode 0-9 through BigMeshTracer equals the per-bounce route bit
    for bit; the film is not blank."""
    scene, cam = soup
    bt = tpk.BigMeshTracer(scene)
    pix = _pixels(which)
    o, d = _camera_rays(cam, pix)
    nrays = 4 if mode == 5 else 1
    got = bt.trace_mode(pix, o, d, FRAME, mode, salt_base=SALT, max_bounces=BOUNCES,
                        style=style, nrays=nrays)
    want = per_bounce(bt, mode, pix, bt._rays(o, d), FRAME, SALT, BOUNCES, style,
                      nrays, bounce=plain_bounce(bt))
    assert got.shape == (3, pix.shape[0])
    assert torch.equal(got, want)
    assert got.max() > 0


@pytest.mark.parametrize("which", ["film", "quadrant"])
def test_collect_hits_are_the_per_bounce_records(soup, which):
    """trace(collect_hits=True) (K1's hits-only collect instance) gives the
    hit records of bigmesh_bounce_plain(collect=True), bounce by bounce,
    and the radiance of trace() without them."""
    scene, cam = soup
    bt = tpk.BigMeshTracer(scene)
    pix = _pixels(which)
    o, d = _camera_rays(cam, pix)
    rgb, (fams, idxs) = bt.trace(pix, o, d, FRAME, SALT, BOUNCES, style="standard",
                                 collect_hits=True)
    assert torch.equal(rgb, bt.trace(pix, o, d, FRAME, SALT, BOUNCES, style="standard"))
    start = tpk._start_state(bt._rays(o, d), "kajiya")
    state = torch.stack([*start[:15], start[15].to(torch.float32)])
    for b in range(BOUNCES):
        state, h = tpk.bigmesh_bounce_plain(bt.tables, bt.counts, pix, state, FRAME,
                                            SALT + 4 * b, collect=True)
        assert torch.equal(fams[b], h[0].long()) and torch.equal(idxs[b], h[1].long())
    assert fams.dtype == idxs.dtype == torch.int64
    want = {-1, 0, 1, 2} if which == "film" else {-1, 0, 2}
    assert set(fams.unique().tolist()) == want


def test_big_mesh_route_takes_the_bvh_forms(soup, monkeypatch):
    """Every one-launch method runs the plain version of K1's or B3's BVH
    form on the caller's rays, never one of B5's."""
    scene, cam = soup
    bt = tpk.BigMeshTracer(scene)
    pix = _pixels("quadrant")
    o, d = _camera_rays(cam, pix)

    def refuse(*a, **k):
        raise AssertionError("the one-launch route ran a per-bounce piece")

    seen = []
    for name in ("trace_plain", "primary_plain"):
        real = getattr(tpk, name)

        def spy(*a, real=real, name=name, **k):
            assert k["tris_last"] and len(k["rays"]) == 6
            seen.append(name)
            return real(*a, **k)

        monkeypatch.setattr(tpk, name, spy)
    monkeypatch.setattr(tpk, "bigmesh_bounce_plain", refuse)
    monkeypatch.setattr(tpk, "bigmesh_search_plain", refuse)
    for mode in range(10):
        bt.trace_mode(pix, o, d, FRAME, mode, salt_base=SALT, max_bounces=BOUNCES,
                      nrays=2)
    bt.trace(pix, o, d, FRAME, SALT, BOUNCES, collect_hits=True)
    assert seen == ["primary_plain"] * 7 + ["trace_plain"] * 4


@pytest.mark.parametrize("scene_name", ["cornell", "soup"])
def test_hits_only_records_are_the_full_records_hits(soup, scene_name):
    """trace_plain(collect="hits") gives the hits of collect=True and its
    radiance, in the row form (Cornell) and the BVH form (the soup);
    PathTracer.trace(collect_hits=True) gives hits_from_record of
    collect_states."""
    if scene_name == "soup":
        scene, cam = soup
    else:
        scene, cam = builtin.cornell_box(aspect=W / H, device="cpu")
    pt = tpk.PathTracer(scene)
    pix = _pixels("film")
    o, d = _camera_rays(cam, pix)
    rays = tuple(c.contiguous() for c in (*o.T, *d.T))
    kw = dict(rays=rays, tris_last=pt.bvh_form)
    out, rec = tpk.trace_plain(pt.tables, pt.counts, pix, FRAME, SALT, 4, "standard",
                               collect=True, **kw)
    out_h, hits = tpk.trace_plain(pt.tables, pt.counts, pix, FRAME, SALT, 4,
                                  "standard", collect="hits", **kw)
    assert torch.equal(out_h, out) and torch.equal(hits, rec.hits)
    assert hits.dtype == torch.int32 and hits.shape == (4, 2, pix.shape[0])
    assert (hits[-1, 0] == -1).any() and (hits[0, 0] >= 0).any()
    rgb, (fams, idxs) = pt.trace(pix, o, d, FRAME, SALT, 4, collect_hits=True)
    (r, g, b), full = pt.trace(pix, o, d, FRAME, SALT, 4, collect_states=True)
    assert torch.equal(torch.stack(rgb), torch.stack([r, g, b]))
    want = pt.hits_from_record(full)
    assert torch.equal(fams, want[0]) and torch.equal(idxs, want[1])
    with pytest.raises(ValueError, match="collect_hits"):
        pt.trace(pix, o, d, FRAME, SALT, 4, collect_hits=True, collect_states=True)
    with pytest.raises(ValueError, match="collect"):
        tpk.trace_plain(pt.tables, pt.counts, pix, FRAME, SALT, 4, "standard",
                        collect="fields", **kw)
    empty, none = tpk.trace_plain(pt.tables, pt.counts, pix, FRAME, SALT, 0,
                                  "standard", collect="hits", **kw)
    assert none.shape == (0, 2, pix.shape[0]) and empty.shape == (3, pix.shape[0])


@pytest.mark.parametrize("mode", range(7))
def test_primary_rays_in_is_the_camera_form(mode):
    """primary_plain(rays=...) on the kernels' own camera rays equals
    primary_plain on cam_params, on a BVH mesh (B3's rays-in and camera
    forms are one function of the rays)."""
    cfg = FilmConfig(W, H)
    scene, cam = builtin.mesh_demo(2, aspect=cfg.aspect, device="cpu")
    pt = tpk.PathTracer(scene)
    pix = _pixels("quadrant")
    cp = tpk.camera_params(cam, cfg)
    rays = tpk._camera_rays_plain(cp.tolist(), cam.mode, pix, FRAME, 0)
    kw = dict(jitter_salt=0, tris_last=True)
    want = tpk.primary_plain(pt.tables, pt.counts, pix, FRAME, SALT, mode, 3, cp,
                             cam.mode, **kw)
    got = tpk.primary_plain(pt.tables, pt.counts, pix, FRAME, SALT, mode, 3, None,
                            cam.mode, rays=rays, **kw)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def jax_soa():
    """tests/test_torch_mesh_grad.py's 120-triangle BVH soup (16x8, 2
    bounces, standard) and JAX's make_fast_kajiya albedo gradient on it,
    the big-mesh route forced on both sides by lowering the routing
    constant, as that file does."""
    import test_torch_mesh_grad as mg

    mp = pytest.MonkeyPatch()
    try:
        for k, v in mg.JAX_SMALL.items():
            mp.setattr(mg.jpk, k, v)
        js, cam = mg._soup_jax()
        pixel, ray = mg._jax_rays(cam)
        grad = mg._jax_fast_albedo_grad(js, pixel, ray)
    finally:
        mp.undo()
    return dict(mg=mg, ts=mg._convert(js), jax_grad=grad,
                pixel=torch.from_numpy(np.asarray(pixel).astype(np.int64)),
                origin=torch.from_numpy(np.array(ray.origin)),
                direction=torch.from_numpy(np.array(ray.direction)))


@pytest.mark.parametrize("route", ["bigmesh", "bvh_form"])
def test_soa_gradients_through_hits_only_records(jax_soa, route, monkeypatch):
    """make_fast_kajiya(backward="soa") on the soup, its records from K1's
    hits-only collect instance through BigMeshTracer (the big-mesh route)
    or PathTracer (BVH form): the albedo gradient against JAX's by the
    mesh-grad bar, and the emission and vertex gradients against autograd
    through kajiya_from_hits on the per-bounce route's records."""
    from rvpt_tpu_torch.ops import fast_grad as tfg

    mg, ts = jax_soa["mg"], jax_soa["ts"]
    if route == "bigmesh":
        monkeypatch.setattr(tpk, "CULL_MAX_TRIS", mg.JAX_SMALL["CULL_MAX_TRIS"])
    assert tpk.is_bigmesh(ts) == (route == "bigmesh")
    pix, o, d = jax_soa["pixel"], jax_soa["origin"], jax_soa["direction"]
    n = pix.shape[0]
    trace = tfg.make_fast_kajiya(ts, mg.SALT, mg.BOUNCES, style="standard",
                                 backward="soa")
    names = ("albedo", "emission", "tri_v0", "tri_v1", "tri_v2")

    def grads(run, cot=None):
        leaves = {k: getattr(ts.materials if k in ("albedo", "emission") else ts, k)
                  .clone().requires_grad_(True) for k in names}
        out = run(mg._with(ts, **leaves))
        return out, torch.autograd.grad(out if cot is not None else torch.mean(out),
                                        list(leaves.values()), cot)

    out, got = grads(lambda s: trace(s, o, d, pix, mg.FRAME))
    assert out.grad_fn.name().startswith("_SoaTrace")
    np.testing.assert_allclose(got[0].numpy(), jax_soa["jax_grad"], rtol=2e-2,
                               atol=1e-5)
    # The per-bounce route's records, from bigmesh_bounce_plain.
    bt = tpk.BigMeshTracer(ts)
    start = tpk._start_state(bt._rays(o, d), "kajiya")
    state = torch.stack([*start[:15], start[15].to(torch.float32)])
    hits = []
    for b in range(mg.BOUNCES):
        state, h = tpk.bigmesh_bounce_plain(bt.tables, bt.counts, pix, state,
                                            mg.FRAME, mg.SALT + 4 * b, collect=True)
        hits.append(h.long())
    fams, idxs = torch.stack([h[0] for h in hits]), torch.stack([h[1] for h in hits])
    cot = torch.from_numpy(np.random.default_rng(9).normal(size=(n, 3))
                           .astype(np.float32) / (3 * n))
    _, got = grads(lambda s: trace(s, o, d, pix, mg.FRAME), cot)
    _, want = grads(lambda s: tfg.kajiya_from_hits(
        s, mg.Ray(o, d), pix, mg.FRAME, mg.SALT, fams, idxs, "standard"), cot)
    for k, g, w in zip(names, got, want):
        assert w.abs().max() > 0, k
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3, atol=1e-6,
                                   err_msg=k)
