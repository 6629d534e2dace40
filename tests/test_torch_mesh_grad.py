"""The mesh gradient path of rvpt_tpu_torch against rvpt_tpu, on the CPU:
K1's BVH-form records, B5's collect records, the paired trace on BVH
scenes through both pullbacks, its routes and the trainer's scope.

Scenes, as tests/test_fast_grad.py:206 and :245: mesh_demo(subdiv=0) (a
BVH scene of 22 triangles: K1's BVH form records, then K2's plain
version), and the 120-triangle BVH soup forced onto the big-mesh route by
lowering the routing constant on both sides (B5's plain version records,
then the SoA replay); films 16x8, 2 bounces, standard.  The JAX side runs
its kernels in interpret mode (the culled K1 and the chunked big-mesh
kernel under the shrunken chunks of that test), once per module.  Bars:
records (family, index) equal; the albedo gradient within rtol 2e-2, atol
1e-5 of autograd through the port's integrator_kajiya and of JAX's
make_fast_kajiya (tests/test_fast_grad.py's bar); the emission and vertex
gradients of the SoA route within rtol 1e-3, atol 1e-6 of autograd through
kajiya_from_hits on the same records (the replay bar).
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
from rvpt_tpu.ops import fast_grad as jfg
from rvpt_tpu.ops import pathkernel as jpk
from rvpt_tpu.render import _pixel_grid as j_pixel_grid
from rvpt_tpu.scene import builtin as jbuiltin
from rvpt_tpu_torch import RenderSettings, convert
from rvpt_tpu_torch.core.types import Ray
from rvpt_tpu_torch.models.integrators import integrator_kajiya
from rvpt_tpu_torch.ops import fast_grad as tfg
from rvpt_tpu_torch.ops import pathkernel as tpk
from rvpt_tpu_torch.scene import builtin as tbuiltin
from rvpt_tpu_torch.train.inverse import _fast_eligible

W, H, BOUNCES, FRAME, SALT = 16, 8, 2, 1, 16
SCENE_FIELDS = ("tri_v0", "tri_v1", "tri_v2", "tri_mat", "sph_center",
                "sph_radius", "sph_mat", "pln_normal", "pln_d", "pln_mat")
# The JAX big-mesh kernel's chunks shrunk as in tests/test_fast_grad.py:249.
JAX_SMALL = {"BIG_CHUNK_T": 1024, "BIG_CHUNK_CLU": 1024 // jpk.CULL_K,
             "BIG_CHUNK_SUP": 1024 // jpk.CULL_K // jpk.CULL_G, "CULL_MAX_TRIS": 64}


def _convert(js):
    d = {k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS}
    for k in ("albedo", "emission", "ior", "kind"):
        d[f"materials.{k}"] = np.asarray(getattr(js.materials, k))
    for k in ("first", "count", "bmin", "bmax"):
        d[f"bvh.{k}"] = np.asarray(getattr(js.bvh, k))
    d["bvh.max_leaf"] = js.bvh.max_leaf
    return convert.scene_from_numpy(d, "cpu")


def _jax_rays(cam):
    pixel, xs, ys = j_pixel_grid(JFilmConfig(width=W, height=H))
    ju, jv = jrng.uniform2(pixel, jnp.uint32(0), jnp.uint32(0))
    ray = jcam.generate_rays(cam, (xs.astype(jnp.float32) + ju) / W,
                             1.0 - (ys.astype(jnp.float32) + jv) / H)
    return pixel, ray


def _soup_jax(n_tri=120, seed=23):
    """tests/test_fast_grad.py:255-269's soup, with its BVH."""
    from rvpt_tpu.scene.bvh import attach_bvh
    from rvpt_tpu.scene.scene import SceneBuilder

    r = np.random.default_rng(seed)
    c = r.uniform(-2, 2, size=(n_tri, 3)).astype(np.float32)
    c[:, 2] += 4.0
    e1 = r.normal(0, 0.5, size=(n_tri, 3)).astype(np.float32)
    e2 = r.normal(0, 0.5, size=(n_tri, 3)).astype(np.float32)
    b = SceneBuilder()
    m = b.add_material(albedo=(0.6, 0.5, 0.4))
    for a, v1, v2 in zip(c, c + e1, c + e2):
        b.add_triangle(tuple(a), tuple(v1), tuple(v2), m)
    lm = b.add_material(albedo=(0, 0, 0), emission=(4, 4, 4))
    b.add_sphere((0.0, 5.0, 2.0), 1.0, lm)
    return attach_bvh(b.build()), jbuiltin.sphere_plane(aspect=W / H)[1]


def _jax_fast_albedo_grad(js, pixel, ray):
    trace = jfg.make_fast_kajiya(js, SALT, BOUNCES, style="standard", interpret=True)

    def loss(albedo):
        mats = dataclasses.replace(js.materials, albedo=albedo)
        s = dataclasses.replace(js, materials=mats)
        return jnp.mean(trace(s, ray.origin, ray.direction, pixel, jnp.uint32(FRAME)))

    return np.asarray(jax.grad(loss)(js.materials.albedo))


@pytest.fixture(scope="module", params=["mesh_demo0", "soup120"])
def case(request):
    """A BVH scene in both packages, the JAX hit records on it (the culled
    K1's collect_states, or the big-mesh kernel's collect_hits) and JAX's
    paired-trace albedo gradient."""
    mp = pytest.MonkeyPatch()
    try:
        if request.param == "mesh_demo0":
            js, cam = jbuiltin.mesh_demo(subdiv=0, aspect=W / H)
        else:
            for k, v in JAX_SMALL.items():
                mp.setattr(jpk, k, v)
            js, cam = _soup_jax()
        pixel, ray = _jax_rays(cam)
        n = pixel.shape[0]
        if request.param == "mesh_demo0":
            pt = jpk.PathTracer(js)
            assert pt.meta.get("culled")
            _, record = pt.trace(pixel, ray.origin, ray.direction, jnp.uint32(FRAME),
                                 SALT, BOUNCES, style="standard", interpret=True,
                                 collect_states=True)
            fams, idxs = pt.hits_from_record(record, n, BOUNCES)
        else:
            assert jpk.is_bigmesh(js)
            bt = jpk.BigMeshTracer(js)
            _, (fams, idxs) = bt.trace(pixel, ray.origin, ray.direction,
                                       jnp.uint32(FRAME), jnp.uint32(SALT), BOUNCES,
                                       style="standard", interpret=True,
                                       collect_hits=True, sort_rays=False)
        grad = _jax_fast_albedo_grad(js, pixel, ray)
    finally:
        mp.undo()
    return dict(
        name=request.param, ts=_convert(js), n=n,
        pixel=torch.from_numpy(np.asarray(pixel).astype(np.int64)),
        ray=Ray(torch.from_numpy(np.array(ray.origin)),
                torch.from_numpy(np.array(ray.direction))),
        fams=np.asarray(fams), idxs=np.asarray(idxs), jax_grad=grad)


@pytest.fixture
def port_route(case, monkeypatch):
    """The port's routing constant lowered as the JAX one for the soup."""
    if case["name"] == "soup120":
        monkeypatch.setattr(tpk, "CULL_MAX_TRIS", JAX_SMALL["CULL_MAX_TRIS"])
    return case


def _port_hits(c):
    ts, ray = c["ts"], c["ray"]
    if tpk.is_bigmesh(ts):
        _, (fams, idxs) = tpk.BigMeshTracer(ts).trace(
            c["pixel"], ray.origin, ray.direction, FRAME, SALT, BOUNCES,
            style="standard", collect_hits=True)
        return fams, idxs
    pt = tpk.PathTracer(ts)
    assert pt.bvh_form
    _, rec = pt.trace(c["pixel"], ray.origin, ray.direction, FRAME, SALT, BOUNCES,
                      style="standard", collect_states=True)
    return pt.hits_from_record(rec)


def test_records_match_jax(port_route):
    """K1's BVH-form records (mesh_demo(0)) and B5's collect records (the
    soup) from the plain versions against the JAX kernels': equal, and
    triangle hits are leaf-order ids."""
    c = port_route
    assert tpk.is_bigmesh(c["ts"]) == (c["name"] == "soup120")
    fams, idxs = _port_hits(c)
    assert fams.shape == (BOUNCES, c["n"])
    np.testing.assert_array_equal(fams.numpy(), c["fams"])
    np.testing.assert_array_equal(idxs.numpy(), c["idxs"])
    assert (fams == 0).any() and (idxs[fams == 0] < c["ts"].num_triangles).all()


def _with(scene, **leaves):
    mats = dataclasses.replace(scene.materials, **{
        k: v for k, v in leaves.items() if k in ("albedo", "emission")})
    return dataclasses.replace(scene, materials=mats, **{
        k: v for k, v in leaves.items() if k.startswith("tri_")})


def test_fast_grad_matches_autograd_and_jax(port_route):
    """tests/test_fast_grad.py:206 and :245 on the port: the paired trace's
    albedo gradient (auto: K2's plain version on mesh_demo(0), the SoA
    replay on the big-mesh soup) against autograd through integrator_kajiya
    and against JAX's; the primal is the tracer's own."""
    c = port_route
    ts, ray, pixel = c["ts"], c["ray"], c["pixel"]
    trace = tfg.make_fast_kajiya(ts, SALT, BOUNCES, style="standard")
    st = RenderSettings(max_bounces=BOUNCES, style="standard")
    a = ts.materials.albedo.clone().requires_grad_(True)
    torch.mean(integrator_kajiya(_with(ts, albedo=a), ray, pixel, FRAME, st,
                                 salt_base=SALT)).backward()
    b = ts.materials.albedo.clone().requires_grad_(True)
    out = trace(_with(ts, albedo=b), ray.origin, ray.direction, pixel, FRAME)
    want_fn = "_SoaTrace" if c["name"] == "soup120" else "_PathTrace"
    assert out.grad_fn.name().startswith(want_fn)
    torch.mean(out).backward()
    assert a.grad.abs().max() > 0
    np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), rtol=2e-2, atol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(), c["jax_grad"], rtol=2e-2, atol=1e-5)
    with torch.no_grad():
        plain = trace(ts, ray.origin, ray.direction, pixel, FRAME)
    assert torch.equal(out.detach(), plain)


@pytest.mark.parametrize("backward", ["soa", "pallas"])
def test_mesh_grads_match_the_replay_from_hits(port_route, backward):
    """Emission and vertex gradients of the paired trace (both pullbacks
    where the scene allows them) against autograd through kajiya_from_hits
    on the same records, with a seeded cotangent."""
    c = port_route
    ts, ray, pixel = c["ts"], c["ray"], c["pixel"]
    if backward == "pallas" and tpk.is_bigmesh(ts):
        with pytest.raises(ValueError, match="big mesh"):
            tfg.make_fast_kajiya(ts, SALT, BOUNCES, backward=backward)
        return
    trace = tfg.make_fast_kajiya(ts, SALT, BOUNCES, style="standard",
                                 backward=backward)
    cot = torch.from_numpy(np.random.default_rng(9).normal(size=(c["n"], 3))
                           .astype(np.float32) / (3 * c["n"]))
    names = ("emission", "tri_v0", "tri_v1", "tri_v2")

    def grads(run):
        leaves = {k: getattr(ts.materials if k == "emission" else ts, k).clone()
                  .requires_grad_(True) for k in names}
        out = run(_with(ts, **leaves))
        return torch.autograd.grad(out, list(leaves.values()), cot)

    fams, idxs = _port_hits(c)
    got = grads(lambda s: trace(s, ray.origin, ray.direction, pixel, FRAME))
    want = grads(lambda s: tfg.kajiya_from_hits(s, ray, pixel, FRAME, SALT, fams,
                                                idxs, "standard"))
    for k, g, w in zip(names, got, want):
        assert w.abs().max() > 0, k
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3, atol=1e-6,
                                   err_msg=k)


def test_fast_kajiya_routes_as_jax():
    """make_fast_kajiya's "auto" takes the JAX rule's route on each scene
    (fast_grad.py:106-109: "soa" on a big mesh, else "pallas" up to 1,024
    triangles, BVH or not); "pallas" refuses a big mesh."""
    from rvpt_tpu.scene.scene import SceneBuilder as JSceneBuilder
    from rvpt_tpu_torch.scene.scene import SceneBuilder

    def soup(builder, n):
        b = builder()
        m = b.add_material(albedo=(0.5, 0.5, 0.5))
        for k in range(n):
            b.add_triangle((k, 0, 3), (k + 1, 0, 3), (k, 1, 3), m)
        return b

    scenes = [(tbuiltin.cornell_box(device="cpu")[0], jbuiltin.cornell_box()[0]),
              (tbuiltin.rabbit(device="cpu")[0], jbuiltin.rabbit()[0]),
              (tbuiltin.mesh_demo(1, device="cpu")[0], jbuiltin.mesh_demo(1)[0]),
              (tbuiltin.mesh_demo(3, device="cpu")[0], jbuiltin.mesh_demo(3)[0]),
              (soup(SceneBuilder, 1025).build("cpu"), soup(JSceneBuilder, 1025).build())]
    n = 8
    o = torch.zeros(n, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    for ts, js in scenes:
        jax_soa = jpk.is_bigmesh(js) or js.num_triangles > 1024
        x = o.clone().requires_grad_(True)
        out = tfg.make_fast_kajiya(ts, SALT, 2)(ts, x, d, n, FRAME)
        assert out.grad_fn.name().startswith("_SoaTrace" if jax_soa else "_PathTrace")
        out = tfg.make_fast_kajiya(ts, SALT, 2, backward="soa")(ts, x, d, n, FRAME)
        assert out.grad_fn.name().startswith("_SoaTrace")
    with pytest.raises(ValueError, match="big mesh"):
        tfg.make_fast_kajiya(scenes[3][0], SALT, 2, backward="pallas")


def test_trainer_admits_bvh_kajiya_scenes():
    """_fast_eligible is the display rule plus Kajiya on every quadrant: BVH
    scenes of any size take the paired trace, other integrators do not."""
    quads = ("top_left_render_mode", "top_right_render_mode",
             "bottom_left_render_mode", "bottom_right_render_mode")
    for scene in (tbuiltin.rabbit(device="cpu")[0],
                  tbuiltin.mesh_demo(3, device="cpu")[0]):
        assert scene.bvh is not None
        assert _fast_eligible(scene, RenderSettings())
        for mode in (5, 7, 8, 10):
            assert not _fast_eligible(scene, RenderSettings(**dict.fromkeys(quads, mode)))
        assert not _fast_eligible(scene, RenderSettings(top_left_render_mode=5))
