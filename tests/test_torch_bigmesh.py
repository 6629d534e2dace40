"""The BVH mesh display path of rvpt_tpu_torch against the JAX package, on
the CPU: ``BigMeshTracer`` (the plain versions of B5 and B6) in every
integrator mode and a split frame, the BVH form of K1 and B3 (their plain
versions with the triangles-last search) against the JAX culled kernels,
the route rule, and the two mesh goldens.

Scenes: the 1,500-triangle mixed soup of tests/test_bigmesh_modes.py
(Lambert, mirror and dielectric triangles, a floor plane, an emissive
sphere), converted from the JAX scene so both sides hold the same
leaf-ordered triangles; the JAX big-mesh kernels run under that file's
``small_chunks`` shrink in interpret mode, once per module.  Films 24x16.
Bars (tests/test_bigmesh_modes.py, tests/test_megakernel.py): >= 99.5% of
pixel channels within rtol/atol 1e-4, Hart >= 99%; goldens as
tests/test_goldens.py (under 0.2% of subpixels more than 2 u8 off).
tests/test_torch_cuda.py holds the CUDA kernels against these plain
versions on the card.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_bigmesh_modes as jmodes
from rvpt_tpu import FilmConfig as JFilmConfig
from rvpt_tpu import RenderSettings as JRenderSettings
from rvpt_tpu.models.integrators import eval_integrator as j_eval
from rvpt_tpu.ops import pathkernel as jpk
from rvpt_tpu.scene import builtin as jbuiltin
from rvpt_tpu.utils.image import read_png
from rvpt_tpu_torch import FilmConfig, RenderSettings, convert
from rvpt_tpu_torch.ops import pathkernel as tpk
from rvpt_tpu_torch.ops.film import Film, chw_to_hwc, to_srgb_u8
from rvpt_tpu_torch.render import (_megakernel_eligible, render_frame,
                                   render_sample_fast_chw)
from rvpt_tpu_torch.scene import builtin as tbuiltin

W, H = 24, 16
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
FRAMES = dict(zip(("kajiya", "primary", "shaded", "culled"),
                  (int(f) for f in np.random.default_rng(4).integers(1, 1000, 4))))
SCENE_FIELDS = ("tri_v0", "tri_v1", "tri_v2", "tri_mat", "sph_center",
                "sph_radius", "sph_mat", "pln_normal", "pln_d", "pln_mat")


def _share(got, want):
    return np.isclose(got, want, rtol=1e-4, atol=1e-4).mean()


def _convert(js):
    d = {k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS}
    for k in ("albedo", "emission", "ior", "kind"):
        d[f"materials.{k}"] = np.asarray(getattr(js.materials, k))
    for k in ("first", "count", "bmin", "bmax"):
        d[f"bvh.{k}"] = np.asarray(getattr(js.bvh, k))
    d["bvh.max_leaf"] = js.bvh.max_leaf
    return convert.scene_from_numpy(d, "cpu")


def _rays(js_cam, n_seed=0):
    """The JAX test file's jittered rays, and the same as port tensors."""
    pixel, ray = jmodes._rays(JFilmConfig(W, H), js_cam, n_seed)
    return (pixel, ray, torch.from_numpy(np.asarray(pixel).astype(np.int64)),
            torch.from_numpy(np.array(ray.origin)),
            torch.from_numpy(np.array(ray.direction)))


@pytest.fixture(scope="module")
def soup():
    """The mixed soup in both packages and the JAX references on it."""
    mp = pytest.MonkeyPatch()
    for k, v in (("BIG_CHUNK_T", 1024), ("BIG_CULL_K", 16),
                 ("BIG_CHUNK_CLU", 1024 // 16),
                 ("BIG_CHUNK_SUP", 1024 // 16 // jpk.CULL_G)):
        mp.setattr(jpk, k, v)
    try:
        js = jmodes._mixed_mesh_scene()
        cam = jbuiltin.sphere_plane(aspect=W / H)[1]
        pixel, ray, *_ = _rays(cam)
        bt = jpk.BigMeshTracer(js)
        ref = {}
        for style in ("reference", "standard"):
            rgb = bt.trace(pixel, ray.origin, ray.direction,
                           jnp.uint32(FRAMES["kajiya"]), 16, 3, style=style,
                           interpret=True, sort_rays=False)
            ref["kajiya", style] = np.stack([np.asarray(c) for c in rgb])
        st = JRenderSettings(max_bounces=4)
        for mode in range(7):
            ref[mode] = np.asarray(j_eval(mode, js, ray, pixel,
                                          jnp.uint32(FRAMES["primary"]), st,
                                          salt_base=jnp.uint32(16))).T
        for mode in (7, 8):
            for style in ("reference", "standard"):
                st = JRenderSettings(max_bounces=3, style=style)
                ref[mode, style] = np.asarray(j_eval(
                    mode, js, ray, pixel, jnp.uint32(FRAMES["shaded"]), st,
                    salt_base=jnp.uint32(16))).T
        ref[10] = np.asarray(j_eval(10, js, ray, pixel, jnp.uint32(0),
                                    JRenderSettings(max_bounces=2),
                                    salt_base=jnp.uint32(16))).T
    finally:
        mp.undo()
    return js, cam, _convert(js), ref


def test_soup_is_a_big_mesh(soup):
    """The route rule sends the soup to BigMeshTracer; PathTracer takes it
    too (its BVH form serves any size, as JAX's culled form does up to
    CULL_MAX_TRIS)."""
    from rvpt_tpu_torch.render import make_tracer

    _, _, ts, _ = soup
    assert ts.num_triangles == 1500 and tpk.is_bigmesh(ts)
    assert isinstance(make_tracer(ts), tpk.BigMeshTracer)
    pt = tpk.PathTracer(ts)
    assert pt.bvh_form and pt.cull is not None


@pytest.mark.parametrize("style", ["reference", "standard"])
def test_bigmesh_kajiya_matches_jax(soup, style):
    """BigMeshTracer.trace (bigmesh_bounce_plain per bounce) against the
    JAX chunked bounce kernel, 3 bounces."""
    js, cam, ts, ref = soup
    _, _, pix, o, d = _rays(cam)
    got = tpk.BigMeshTracer(ts).trace(pix, o, d, FRAMES["kajiya"], 16, 3,
                                      style=style).numpy()
    share = _share(got, ref["kajiya", style])
    assert share >= 0.995, f"{style}: only {share:.4%} of channels match"


@pytest.mark.parametrize("mode", range(7))
def test_bigmesh_primary_modes_match_jax(soup, mode):
    js, cam, ts, ref = soup
    _, _, pix, o, d = _rays(cam)
    got = tpk.BigMeshTracer(ts).trace_primary(
        pix, o, d, FRAMES["primary"], mode, salt_base=16,
        nrays=4 if mode == 5 else 1).numpy()
    share = _share(got, ref[mode])
    assert share >= 0.995, f"mode {mode}: only {share:.4%} of channels match"


@pytest.mark.parametrize("style", ["reference", "standard"])
@pytest.mark.parametrize("mode", [7, 8])
def test_bigmesh_whitted_cook_match_jax(soup, mode, style):
    js, cam, ts, ref = soup
    _, _, pix, o, d = _rays(cam)
    got = tpk.BigMeshTracer(ts).trace_shaded(
        pix, o, d, FRAMES["shaded"], {7: "whitted", 8: "cook"}[mode],
        salt_base=16, max_bounces=3, style=style).numpy()
    share = _share(got, ref[mode, style])
    assert share >= 0.995, f"mode {mode}: only {share:.4%} of channels match"


def test_bigmesh_hart_matches_jax(soup):
    js, cam, ts, ref = soup
    _, _, pix, o, d = _rays(cam)
    got = tpk.BigMeshTracer(ts).trace_hart(pix, o, d).numpy()
    share = _share(got, ref[10])
    assert share >= 0.99, f"only {share:.4%} of channels match"


def _march_rays(ts, o, d):
    """The soup's camera rays, then rays whose origins lie on a triangle's
    centroid or 0.05 off it along +z (within MARCH_EPS of the mesh), each
    pointing somewhere."""
    k = torch.arange(0, ts.num_triangles, 97)
    cen = (ts.tri_v0[k] + ts.tri_v1[k] + ts.tri_v2[k]) / 3.0
    near = torch.cat([cen, cen + torch.tensor([0.0, 0.0, 0.05])])
    aim = torch.nn.functional.normalize(
        torch.from_numpy(np.random.default_rng(5).normal(size=(near.shape[0], 3))
                         .astype(np.float32)), dim=1)
    return torch.cat([o, near]), torch.cat([d, aim])


@pytest.fixture(scope="module")
def jax_march(soup):
    """JAX BigMeshTracer.trace_hart (its per-step Pallas distance kernel in
    interpret mode, under the soup's chunk shrink) on the rays of
    ``_march_rays``, at mint 0 and 0.7 -> {mint: f32[N] value}."""
    js, cam, ts, _ = soup
    _, _, _, o, d = _rays(cam)
    o, d = _march_rays(ts, o, d)
    mp = pytest.MonkeyPatch()
    for k, v in (("BIG_CHUNK_T", 1024), ("BIG_CULL_K", 16),
                 ("BIG_CHUNK_CLU", 1024 // 16),
                 ("BIG_CHUNK_SUP", 1024 // 16 // jpk.CULL_G)):
        mp.setattr(jpk, k, v)
    try:
        bt = jpk.BigMeshTracer(js)
        pix = jnp.arange(o.shape[0], dtype=jnp.uint32)
        return {mint: np.asarray(bt.trace_hart(pix, jnp.asarray(o.numpy()),
                                               jnp.asarray(d.numpy()), mint=mint,
                                               interpret=True)[0])
                for mint in (0.0, 0.7)}
    finally:
        mp.undo()


@pytest.mark.parametrize("mint", [0.0, 0.7])
def test_bigmesh_march_plain_matches_jax_trace_hart(soup, jax_march, mint):
    """bigmesh_march_plain, the CPU route of BigMeshTracer.trace_hart,
    against JAX's BigMeshTracer.trace_hart on the soup's camera rays and on
    origins within MARCH_EPS of a triangle (they stop at step 0 when mint
    is 0), by the Hart bar (>= 99% within 1e-4)."""
    _, cam, ts, _ = soup
    _, _, pix, o, d = _rays(cam)
    o, d = _march_rays(ts, o, d)
    bt = tpk.BigMeshTracer(ts)
    steps = tpk.bigmesh_march_plain(bt.hart_tables, bt.hart_count, o.T.contiguous(),
                                    d.T.contiguous(), mint)
    got = bt.trace_hart(torch.arange(o.shape[0]), o, d, mint=mint)
    assert torch.equal(got[0], steps.to(torch.float32) * (1.0 / (tpk.MARCH_ITER - 1)))
    share = _share(got[0].numpy(), jax_march[mint])
    assert share >= 0.99, f"only {share:.4%} of rays match"
    n_near = 2 * len(range(0, ts.num_triangles, 97))
    if mint == 0.0:
        assert (steps[-n_near:] == 0).all()
    assert (steps < tpk.MARCH_ITER).any() and (steps == tpk.MARCH_ITER).any()


def test_bigmesh_march_plain_dead_lanes_and_empty(soup):
    """A lane outside ``live`` writes MARCH_ITER and the live lanes march
    as without the mask; no rays give an empty result."""
    _, cam, ts, _ = soup
    _, _, _, o, d = _rays(cam)
    bt = tpk.BigMeshTracer(ts)
    o3, d3 = o.T.contiguous(), d.T.contiguous()
    live = torch.arange(o.shape[0]) % 3 != 0
    every = tpk.bigmesh_march_plain(bt.hart_tables, bt.hart_count, o3, d3)
    got = tpk.bigmesh_march_plain(bt.hart_tables, bt.hart_count, o3, d3, live=live)
    assert torch.equal(got[live], every[live])
    assert (got[~live] == tpk.MARCH_ITER).all()
    empty = tpk.bigmesh_march_plain(bt.hart_tables, bt.hart_count,
                                    torch.zeros(3, 0), torch.zeros(3, 0))
    assert empty.shape == (0,) and empty.dtype == torch.int32


def test_bigmesh_search_misses_and_dead_lanes(soup):
    """search: fam -1 and t 3e38 on rays that miss everything and on every
    lane that is not live; the bounce passes dead lanes through exactly."""
    _, _, ts, _ = soup
    bt = tpk.BigMeshTracer(ts)
    n = 64
    zero, up = torch.zeros(n), torch.ones(n)
    w = bt.search((zero, up * 50.0, zero), (zero, up, zero), up > 0)
    assert (w[5] == -1).all() and (w[0] >= 1e30).all()
    o = (zero, zero, torch.full((n,), -1.0))
    d = (torch.linspace(-0.3, 0.3, n), torch.linspace(-0.2, 0.2, n), up)
    live = torch.arange(n) % 3 != 0
    w = bt.search(o, d, live)
    assert (w[5][~live] == -1).all() and (w[5][live] >= 0).any()
    state = torch.stack([*o, *d, *(torch.rand(9) * torch.ones(n, 1)).T,
                         live.to(torch.float32)])
    new = bt.bounce(torch.arange(n), state, 3, 16)
    assert torch.equal(new[:, ~live], state[:, ~live])
    assert not torch.equal(new[:, live], state[:, live])
    # The collect instance's hit records: the radiance unchanged, -1 on
    # the rays that miss and on every bounce after a lane ended.
    args = (torch.arange(n), torch.stack(o, 1), torch.stack(d, 1), 0, 16, 2)
    rgb, (fams, idxs) = bt.trace(*args, collect_hits=True)
    assert torch.equal(rgb, bt.trace(*args))
    assert fams.shape == idxs.shape == (2, n) and fams.dtype == torch.int64
    assert (fams[0] >= 0).any() and ((fams == -1) == (idxs == -1)).all()
    assert ((fams[1] == -1) | (fams[0] >= 0)).all()


def test_bigmesh_split_screen_matches_jax(soup):
    """A 4-way split frame on the big mesh through render_sample_fast_chw
    (BigMeshTracer per quadrant, on its pixel ids) against the JAX XLA
    split render (render.py:382-480 on the JAX side's plain path)."""
    from rvpt_tpu.render import render_sample_chw as j_render

    js, cam, ts, _ = soup
    cfg = FilmConfig(32, 16)
    jcam = jbuiltin.sphere_plane(aspect=cfg.aspect)[1]
    tcam = tbuiltin.sphere_plane(aspect=cfg.aspect, device="cpu")[1]
    kw = dict(max_bounces=2, top_left_render_mode=3, top_right_render_mode=9,
              bottom_left_render_mode=0, bottom_right_render_mode=7)
    want = np.asarray(j_render(js, jcam, JRenderSettings(**kw),
                               JFilmConfig(32, 16), jnp.uint32(1)))
    got = render_sample_fast_chw(ts, tcam, RenderSettings(**kw), cfg, 1).numpy()
    share = _share(got, want)
    assert share >= 0.995, f"split: only {share:.4%} of channels match"


def test_routes_agree_with_jax(monkeypatch):
    """is_bigmesh and _megakernel_eligible of every builtin, as the JAX
    package decides them on its kernel backend."""
    from rvpt_tpu.ops import intersect as jint
    from rvpt_tpu.render import _megakernel_eligible as j_eligible

    monkeypatch.setattr(jint, "_BACKEND", "pallas")
    cases = [("cornell_box", {}), ("sphere_plane", {}), ("rabbit", {}),
             ("mesh_demo", dict(subdiv=2)), ("mesh_demo", dict(subdiv=3)),
             ("terrain_demo", dict(n=40))]
    settings = [dict.fromkeys(("top_left_render_mode", "top_right_render_mode",
                               "bottom_left_render_mode",
                               "bottom_right_render_mode"), m)
                for m in (0, 5, 9, 10)]
    settings.append(dict(top_left_render_mode=5, top_right_render_mode=7,
                         bottom_left_render_mode=10, bottom_right_render_mode=9))
    for name, kw in cases:
        js, _ = getattr(jbuiltin, name)(**kw)
        ts, _ = getattr(tbuiltin, name)(device="cpu", **kw)
        assert tpk.is_bigmesh(ts) == jpk.is_bigmesh(js), name
        for st in settings:
            assert (_megakernel_eligible(ts, RenderSettings(**st))
                    == j_eligible(js, JRenderSettings(**st))), (name, st)
    mesh3, _ = tbuiltin.mesh_demo(subdiv=3, device="cpu")
    assert isinstance(tpk.BigMeshTracer(mesh3), tpk.BigMeshTracer)
    rabbit, _ = tbuiltin.rabbit(device="cpu")
    assert tpk.PathTracer(rabbit).bvh_form


@pytest.fixture(scope="module")
def culled():
    """The JAX culled K1 (Kajiya 3 bounces, both styles) and B3 (AO) on
    mesh_demo(2) in interpret mode, once."""
    cfg = JFilmConfig(W, H)
    js, jcam = jbuiltin.mesh_demo(subdiv=2, aspect=cfg.aspect)
    pixel, ray, *_ = _rays(jcam, n_seed=2)
    pt = jpk.PathTracer(js)
    assert pt.meta.get("culled")
    frame = jnp.uint32(FRAMES["culled"])
    out = {}
    for style in ("reference", "standard"):
        rgb = pt.trace(pixel, ray.origin, ray.direction, frame, salt_base=16,
                       max_bounces=3, style=style, interpret=True)
        out["kajiya", style] = np.stack([np.asarray(c) for c in rgb])
    cp = jpk.camera_params(jcam, cfg)
    for mode in (5,):
        rgb = pt.trace_primary(pixel, frame, mode, cam_params=cp,
                               cam_mode=jcam.mode, salt_base=16, jitter_salt=0,
                               nrays=3, interpret=True)
        out[mode] = np.stack([np.asarray(c) for c in rgb])
    return out


@pytest.mark.parametrize("style", ["reference", "standard"])
def test_culled_k1_plain_matches_jax(culled, style):
    """K1's BVH form on the CPU (trace_plain with the triangles-last
    search) against the JAX culled kernel, rays passed in."""
    ts, tcam = tbuiltin.mesh_demo(subdiv=2, aspect=W / H, device="cpu")
    jcam = jbuiltin.mesh_demo(subdiv=2, aspect=W / H)[1]
    _, _, pix, o, d = _rays(jcam, n_seed=2)
    pt = tpk.PathTracer(ts)
    assert pt.bvh_form and pt.nodes is not None
    got = torch.stack(pt.trace(pix, o, d, FRAMES["culled"], 16, 3,
                               style=style)).numpy()
    share = _share(got, culled["kajiya", style])
    assert share >= 0.995, f"{style}: only {share:.4%} of channels match"


@pytest.mark.parametrize("mode", [5])
def test_culled_b3_plain_matches_jax(culled, mode):
    ts, tcam = tbuiltin.mesh_demo(subdiv=2, aspect=W / H, device="cpu")
    pt = tpk.PathTracer(ts)
    got = pt.trace_primary(W * H, FRAMES["culled"], mode,
                           cam_params=tpk.camera_params(tcam, FilmConfig(W, H)),
                           cam_mode=tcam.mode, salt_base=16, jitter_salt=0,
                           nrays=3).numpy()
    share = _share(got, culled[mode])
    assert share >= 0.995, f"mode {mode}: only {share:.4%} of channels match"


def test_bvh_form_records_wait_for_a12():
    """K1's BVH form now writes records (ROADMAP A12): the radiance of the
    trace without them, and triangle hits by leaf-order id."""
    ts, tcam = tbuiltin.rabbit(aspect=W / H, device="cpu")
    jcam = jbuiltin.rabbit(aspect=W / H)[1]
    _, _, pix, o, d = _rays(jcam)
    pt = tpk.PathTracer(ts)
    (r, g, b), rec = pt.trace(pix, o, d, 0, 16, 2, collect_states=True)
    assert torch.equal(torch.stack([r, g, b]), torch.stack(pt.trace(pix, o, d, 0, 16, 2)))
    fams, idxs = pt.hits_from_record(rec)
    tri = fams == 0
    assert tri.any() and (idxs[tri] < ts.num_triangles).all()


@pytest.mark.parametrize("name", ["rabbit_kajiya", "mesh2_kajiya"])
def test_mesh_goldens(name):
    """rabbit at 256x128 and mesh_demo(2) at 128x128, 2 frames x 8 bounces
    (tests/make_goldens.py), through the kernels' route on the CPU (K1's
    BVH form, its plain version)."""
    size = (256, 128) if name == "rabbit_kajiya" else (128, 128)
    cfg = FilmConfig(*size)
    if name == "rabbit_kajiya":
        scene, cam = tbuiltin.rabbit(aspect=cfg.aspect, device="cpu")
    else:
        scene, cam = tbuiltin.mesh_demo(subdiv=2, aspect=cfg.aspect, device="cpu")
    st = RenderSettings(max_bounces=8)
    assert _megakernel_eligible(scene, st)
    film = Film.create(cfg.height, cfg.width, device="cpu")
    for f in range(2):
        film, img = render_frame(scene, cam, st, cfg, film, f == 0)
    got = to_srgb_u8(chw_to_hwc(img)).numpy()
    want = read_png(os.path.join(GOLDEN_DIR, f"{name}.png"))
    assert got.shape == want.shape
    frac = (np.abs(got.astype(np.int32) - want.astype(np.int32)) > 2).mean()
    assert frac < 0.002, f"golden {name}: {frac:.4%} of subpixels differ by >2"


@pytest.mark.parametrize("integ", ["kajiya", "whitted", "cook", "ao"])
def test_on_search_sees_every_search(integ):
    """The plain versions' ``on_search`` hook (chip_smoke.py's bounds count
    the walk's work through it with the kernels' counting instance) sees
    the rays of every search, on the live lanes that ``work`` counts."""
    cfg = FilmConfig(24, 16)
    ts, cam = tbuiltin.mesh_demo(2, aspect=cfg.aspect, device="cpu")
    pt = tpk.PathTracer(ts)
    assert pt.bvh_form
    n = cfg.num_pixels
    pix = torch.arange(n)
    seen = []

    def on_search(o3, d3, live):
        assert len(o3) == len(d3) == 3 and o3[0].shape == d3[2].shape == (n,)
        seen.append(n if live is None else int(live.sum()))

    kw = dict(cam_params=tpk.camera_params(cam, cfg), cam_mode=cam.mode,
              jitter_salt=0, tris_last=True, on_search=on_search)
    if integ == "ao":
        tpk.primary_plain(pt.tables, pt.counts, pix, 1, 16, 5, 3, **kw)
        assert seen[0] == n and len(seen) == 4
        assert 0 < seen[1] == seen[2] == seen[3] < n
    else:
        work = {}
        tpk.trace_plain(pt.tables, pt.counts, pix, 1, 16, 4, "standard",
                        integ=integ, work=work, **kw)
        assert sum(seen) == work["search"] > n
        assert len(seen) == 4 + {"kajiya": 0, "whitted": 4, "cook": 1}[integ]


def test_walk_counts_need_the_card():
    """The walks' counting instances are kernels: on CPU tensors they
    raise, they have no plain stand-in."""
    ts, _ = tbuiltin.mesh_demo(3, aspect=1.0, device="cpu")
    bt = tpk.BigMeshTracer(ts)
    rays = tuple(torch.zeros(8) for _ in range(6))
    live = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        tpk.count_bvh_walk(bt.tables, bt.counts, bt.nodes, rays, live)
    with pytest.raises(ValueError, match="CUDA"):
        tpk.count_hart_walk(bt.hart_tables, bt.hart_count, bt.nodes,
                            torch.zeros(3, 8), live)
    with pytest.raises(ValueError, match="CUDA"):
        tpk.count_hart_march(bt.hart_tables, bt.hart_count, bt.nodes,
                             torch.zeros(3, 8), torch.zeros(3, 8))


def test_march_escape_ball_bounds_the_mesh(soup):
    """B6's escape ball holds every vertex with ESCAPE_MARGIN to spare,
    and its radius is the padded root box's half diagonal plus that
    margin, to within the slack for the centre's rounding."""
    _, _, ts, _ = soup
    bt = tpk.BigMeshTracer(ts)
    cx, cy, cz, r2 = tpk.march_escape(bt.nodes)
    assert bt.escape == (cx, cy, cz, r2)
    c = torch.tensor([cx, cy, cz], dtype=torch.float64)
    v = torch.cat([ts.tri_v0, ts.tri_v1, ts.tri_v2]).double()
    far = float(torch.linalg.vector_norm(v - c, dim=1).max())
    assert far + tpk.ESCAPE_MARGIN <= r2 ** 0.5
    lo, hi = bt.nodes[0, :3].double(), bt.nodes[0, 3:6].double()
    half = float(torch.linalg.vector_norm(hi - lo)) / 2
    assert r2 ** 0.5 == pytest.approx(half + tpk.ESCAPE_MARGIN, rel=1e-5)


def test_march_launcher_refuses_cpu_tensors():
    """launch_bigmesh_march, B6's march instance, takes CUDA tensors only
    (a CPU tensor goes to bigmesh_march_plain through trace_hart)."""
    ts, _ = tbuiltin.mesh_demo(3, aspect=1.0, device="cpu")
    bt = tpk.BigMeshTracer(ts)
    before = tpk.launch_bigmesh_march.launches
    with pytest.raises(ValueError, match="CUDA"):
        tpk.launch_bigmesh_march(bt.hart_tables, bt.hart_count, bt.nodes,
                                 torch.zeros(3, 8), torch.zeros(3, 8))
    assert tpk.launch_bigmesh_march.launches == before
