"""The training path of rvpt_tpu_torch against rvpt_tpu: trace records,
the whole-chain pullback, the paired trace and the replay from hits.

On the CPU the port runs the plain versions of its kernels (trace_plain
with records, bwd_plain); the JAX side runs its Pallas kernels K1 and K2
in interpret mode, as tests/test_fast_grad.py does, once per module.
Films are 24x16, 3 bounces.  Bars:

* records: (family, index) equal on >= 99.5% of ray-bounces and the 13
  fields >= 99.5% within 1e-4 (the tracer bar: fma rounding flips rare
  discrete decisions);
* pullback fed the JAX forward's record: all 24 table columns and the o/d
  cotangents within rtol 1e-4, atol 1e-6 (tests/test_fast_grad.py:188);
* paired-trace gradients against JAX's and against autograd of the port's
  integrator: rtol 2e-2, atol 1e-5 (albedo) and 1e-6 (camera);
* replay from the same hit records: rtol 1e-4.
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
from rvpt_tpu_torch import FilmConfig, RenderSettings, convert
from rvpt_tpu_torch.core import rng as trng
from rvpt_tpu_torch.core.types import Ray
from rvpt_tpu_torch.models import camera as tcam
from rvpt_tpu_torch.models.integrators import integrator_kajiya
from rvpt_tpu_torch.ops import fast_grad as tfg
from rvpt_tpu_torch.ops import pathkernel as tpk
from rvpt_tpu_torch.scene import builtin as tbuiltin

W, H, BOUNCES, FRAME, SALT = 24, 16, 3, 1, 16
CASES = {"cornell": ("cornell_box", "reference"),
         "sphere_plane": ("sphere_plane", "standard")}


def _jax_rays(cam):
    cfg = JFilmConfig(width=W, height=H)
    pixel, xs, ys = j_pixel_grid(cfg)
    ju, jv = jrng.uniform2(pixel, jnp.uint32(0), jnp.uint32(0))
    cx = (xs.astype(jnp.float32) + ju) / cfg.width
    cy = 1.0 - (ys.astype(jnp.float32) + jv) / cfg.height
    return pixel, jcam.generate_rays(cam, cx, cy)


def _torch_rays(cam, frame=0, salt=0):
    from rvpt_tpu_torch.render import _pixel_grid

    cfg = FilmConfig(width=W, height=H)
    pixel, xs, ys = _pixel_grid(cfg, "cpu")
    ju, jv = trng.uniform2(pixel, frame, salt)
    cx = (xs.to(torch.float32) + ju) / cfg.width
    cy = 1.0 - (ys.to(torch.float32) + jv) / cfg.height
    return pixel, tcam.generate_rays(cam, cx, cy)


def _jax_scene_dict(scene):
    from rvpt_tpu_torch.scene.scene import ARRAY_FIELDS

    d = {k: np.asarray(getattr(scene, k)) for k in ARRAY_FIELDS}
    for k in ("albedo", "emission", "ior", "kind"):
        d[f"materials.{k}"] = np.asarray(getattr(scene.materials, k))
    return d


@pytest.fixture(scope="module", params=list(CASES))
def jax_case(request):
    """One JAX forward with records and one JAX pullback (interpret mode)
    for a scene and style; every input as numpy for the port."""
    maker, style = CASES[request.param]
    js, jc = getattr(jbuiltin, maker)(aspect=W / H)
    pixel, ray = _jax_rays(jc)
    n = pixel.shape[0]
    pt = jpk.PathTracer(js)
    (r, g, b), record = pt.trace(
        pixel, ray.origin, ray.direction, jnp.uint32(FRAME), SALT, BOUNCES,
        style=style, interpret=True, collect_states=True)
    fams, idxs = pt.hits_from_record(record, n, BOUNCES)
    cot = np.random.default_rng(3).normal(size=(n, 3)).astype(np.float32)
    g_rows = tuple(jpk._to_tiles(jnp.asarray(cot[:, k])) for k in range(3))
    gtabs, go, gd = jpk.bwd_path(js, record, jnp.uint32(FRAME), g_rows, SALT,
                                 style, interpret=True)
    groups = [(g_, [np.asarray(x) for x in st], np.asarray(f), np.asarray(i))
              for g_, st, f, i in record["groups"]]
    return dict(
        name=request.param, style=style, js=js, jray=ray, jpixel=pixel, n=n,
        scene=convert.scene_from_numpy(_jax_scene_dict(js), "cpu"),
        pixel=torch.from_numpy(np.asarray(pixel).astype(np.int64)),
        origin=torch.from_numpy(np.array(ray.origin)),
        direction=torch.from_numpy(np.array(ray.direction)),
        rgb=np.stack([np.asarray(r), np.asarray(g), np.asarray(b)]),
        record=convert.record_from_numpy(groups, n, "cpu"),
        fams=fams, idxs=idxs, cot=cot,
        gtabs=[np.asarray(c)[:, 0, 0] for c in gtabs],
        go=np.stack([np.asarray(x).reshape(-1)[:n] for x in go], -1),
        gd=np.stack([np.asarray(x).reshape(-1)[:n] for x in gd], -1),
    )


def test_records_match_jax_collect_states(jax_case):
    """(a) trace_plain's records against the JAX kernel's collect_states."""
    c = jax_case
    got, rec = tpk.PathTracer(c["scene"]).forward(
        c["pixel"], c["origin"], c["direction"], FRAME, SALT, BOUNCES,
        style=c["style"], collect_states=True)
    want = c["record"]
    assert rec.fields.shape == want.fields.shape == (BOUNCES, 13, c["n"])
    assert rec.hits.dtype == torch.int32 and rec.hits.shape == (BOUNCES, 2, c["n"])
    hits_same = (rec.hits == want.hits).all(dim=1).float().mean().item()
    assert hits_same >= 0.995, f"only {hits_same:.4%} of ray-bounce hits agree"
    fields_close = torch.isclose(rec.fields, want.fields, rtol=1e-4,
                                 atol=1e-4).float().mean().item()
    assert fields_close >= 0.995, f"only {fields_close:.4%} of fields agree"
    share = np.isclose(got.numpy(), c["rgb"], rtol=1e-4, atol=1e-4).mean()
    assert share >= 0.995
    # Dead or missed lanes carry -1 hits; the first bounce is all live.
    assert (rec.fields[0, 12] == 1.0).all()
    dead = rec.fields[:, 12] == 0.0
    assert (rec.hits[:, 0][dead] == -1).all() and (rec.hits[:, 1][dead] == -1).all()


def test_bwd_plain_matches_jax_bwd_path_on_jax_record(jax_case):
    """(b) The plain pullback fed the JAX forward's record against the JAX
    kernel pullback: the 24 table columns and the o/d cotangents."""
    c = jax_case
    tables, counts = tpk.pack_bwd(c["scene"])
    gflat, go, gd = tpk.bwd_plain(tables, counts, c["record"], c["pixel"],
                                  FRAME, SALT, c["style"],
                                  torch.from_numpy(c["cot"]))
    cols = tpk.gtabs_from_flat(gflat, counts)
    sizes = [counts[0]] * 9 + [counts[1]] * 4 + [counts[2]] * 4 + [counts[3]] * 7
    total = 0.0
    for name, got, want, rows in zip(tpk.DIFF_FIELDS, cols, c["gtabs"], sizes):
        np.testing.assert_allclose(got.numpy(), want[:rows], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        total += float(np.abs(want[:rows]).sum())
    assert total > 0.0
    np.testing.assert_allclose(go.numpy(), c["go"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gd.numpy(), c["gd"], rtol=1e-4, atol=1e-6)


def test_replay_from_hits_matches_jax(jax_case):
    """(e) kajiya_from_hits on the JAX forward's hit records."""
    c = jax_case
    want = np.asarray(jfg.kajiya_from_hits(
        c["js"], c["jray"], c["jpixel"], jnp.uint32(FRAME), SALT, c["fams"],
        c["idxs"], c["style"]))
    fams, idxs = tpk.PathTracer.hits_from_record(c["record"])
    got = tfg.kajiya_from_hits(c["scene"], Ray(c["origin"], c["direction"]),
                               c["pixel"], FRAME, SALT, fams, idxs, c["style"])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    # and the replay reproduces the tracer's own radiance
    assert np.isclose(got.numpy().T, c["rgb"], rtol=1e-4, atol=1e-4).mean() >= 0.995


def _cam_loss_torch(scene, trace, translation, fov, albedo):
    cam = dataclasses.replace(
        tcam.Camera.create(aspect=W / H, fov=68.0, device="cpu"),
        translation=translation, fov=fov)
    mats = dataclasses.replace(scene.materials, albedo=albedo)
    s = dataclasses.replace(scene, materials=mats)
    pixel, ray = _torch_rays(cam)
    return torch.mean(trace(s, ray.origin, ray.direction, pixel, FRAME))


@pytest.fixture(scope="module")
def jax_fast_grads():
    """JAX make_fast_kajiya gradients (interpret mode) of the mean-image
    loss w.r.t. albedo, camera translation and fov: Cornell, standard."""
    js, _ = jbuiltin.cornell_box(aspect=W / H)
    trace = jfg.make_fast_kajiya(js, SALT, BOUNCES, style="standard",
                                 interpret=True)
    cfg = JFilmConfig(width=W, height=H)
    pixel, xs, ys = j_pixel_grid(cfg)

    def loss(albedo, translation, fov):
        cam = dataclasses.replace(
            jcam.Camera.create(aspect=W / H, fov=68.0),
            translation=translation, fov=fov)
        ju, jv = jrng.uniform2(pixel, jnp.uint32(0), jnp.uint32(0))
        cx = (xs.astype(jnp.float32) + ju) / cfg.width
        cy = 1.0 - (ys.astype(jnp.float32) + jv) / cfg.height
        ray = jcam.generate_rays(cam, cx, cy)
        mats = dataclasses.replace(js.materials, albedo=albedo)
        s = dataclasses.replace(js, materials=mats)
        return jnp.mean(trace(s, ray.origin, ray.direction, pixel,
                              jnp.uint32(FRAME)))

    t0 = jnp.asarray([0.05, -0.02, 0.1], jnp.float32)
    f0 = jnp.asarray(68.0, jnp.float32)
    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        js.materials.albedo, t0, f0)
    return float(val), [np.asarray(g) for g in grads], np.array(t0)


def test_fast_kajiya_grads_match_jax(jax_fast_grads):
    """(c) Albedo and camera (translation, fov) gradients of the paired
    trace against JAX's make_fast_kajiya; the primal equals the port's own
    tracer."""
    val, (ga, gt, gf), t0 = jax_fast_grads
    scene, _ = tbuiltin.cornell_box(aspect=W / H, device="cpu")
    trace = tfg.make_fast_kajiya(scene, SALT, BOUNCES, style="standard")
    albedo = scene.materials.albedo.clone().requires_grad_(True)
    translation = torch.from_numpy(t0).requires_grad_(True)
    fov = torch.tensor(68.0, requires_grad=True)
    loss = _cam_loss_torch(scene, trace, translation, fov, albedo)
    loss.backward()
    assert abs(loss.item() - val) <= 1e-4 * abs(val)
    assert np.abs(ga).max() > 0
    np.testing.assert_allclose(albedo.grad.numpy(), ga, rtol=2e-2, atol=1e-5)
    np.testing.assert_allclose(translation.grad.numpy(), gt, rtol=2e-2, atol=1e-6)
    np.testing.assert_allclose(fov.grad.numpy(), gf, rtol=2e-2, atol=1e-6)

    # The primal is the tracer's own forward, records or not.
    pixel, ray = _torch_rays(tcam.Camera.create(aspect=W / H, fov=68.0,
                                                device="cpu"))
    o = ray.origin.clone().requires_grad_(True)
    paired = trace(scene, o, ray.direction, pixel, FRAME)
    r, g, b = tpk.PathTracer(scene).trace(pixel, ray.origin, ray.direction,
                                          FRAME, SALT, BOUNCES, style="standard")
    assert paired.requires_grad
    assert torch.equal(paired.detach(), torch.stack([r, g, b], dim=-1))


@pytest.mark.parametrize("leaf", ["albedo", "emission"])
def test_fast_grad_matches_port_autograd(leaf):
    """(d) The paired trace's material gradients against torch.autograd
    through the port's integrator_kajiya (same RNG streams and decisions),
    the tests/test_fast_grad.py:52 bar."""
    scene, cam = tbuiltin.cornell_box(aspect=W / H, device="cpu")
    pixel, ray = _torch_rays(cam)
    st = RenderSettings(max_bounces=BOUNCES, style="standard")
    trace = tfg.make_fast_kajiya(scene, SALT, BOUNCES, style="standard")

    def scene_with(x):
        mats = dataclasses.replace(scene.materials, **{leaf: x})
        return dataclasses.replace(scene, materials=mats)

    x0 = getattr(scene.materials, leaf)
    a = x0.clone().requires_grad_(True)
    torch.mean(integrator_kajiya(scene_with(a), ray, pixel, FRAME, st,
                                 salt_base=SALT)).backward()
    b = x0.clone().requires_grad_(True)
    torch.mean(trace(scene_with(b), ray.origin, ray.direction, pixel,
                     FRAME)).backward()
    assert a.grad.abs().max() > 0
    np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), rtol=2e-2,
                               atol=1e-5)


def test_fast_grad_camera_matches_port_autograd():
    """(d) The camera's translation and fov gradients, which reach the scene
    only through the pullback's origin and direction cotangents, against
    torch.autograd through the port's integrator_kajiya."""
    scene, cam = tbuiltin.cornell_box(aspect=W / H, device="cpu")
    st = RenderSettings(max_bounces=BOUNCES, style="standard")
    trace = tfg.make_fast_kajiya(scene, SALT, BOUNCES, style="standard")

    def grads(fast):
        tr = torch.tensor([0.05, -0.02, 0.1], requires_grad=True)
        fov = cam.fov.clone().requires_grad_(True)
        pixel, ray = _torch_rays(dataclasses.replace(cam, translation=tr, fov=fov))
        if fast:
            out = trace(scene, ray.origin, ray.direction, pixel, FRAME)
        else:
            out = integrator_kajiya(scene, ray, pixel, FRAME, st, salt_base=SALT)
        return torch.autograd.grad(torch.mean(out), [tr, fov])

    for got, want in zip(grads(True), grads(False)):
        assert want.abs().max() > 0
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-2,
                                   atol=1e-7)


def test_fast_kajiya_routes():
    """backward="soa" and scenes past the kernel backward's bound take the
    SoA replay (ROADMAP A12, done); an unknown route raises."""
    from rvpt_tpu_torch.scene.scene import SceneBuilder

    scene, cam = tbuiltin.cornell_box(device="cpu")
    pixel, ray = _torch_rays(cam)
    b = SceneBuilder()
    m = b.add_material(albedo=(0.5, 0.5, 0.5))
    for k in range(tpk.MAX_BWD_TRIANGLES + 1):
        b.add_triangle((k, 0, 3), (k + 1, 0, 3), (k, 1, 3), m)
    for s, backward in ((scene, "soa"), (b.build("cpu"), "auto")):
        albedo = s.materials.albedo.clone().requires_grad_(True)
        mats = dataclasses.replace(s.materials, albedo=albedo)
        trace = tfg.make_fast_kajiya(s, SALT, 2, backward=backward)
        out = trace(dataclasses.replace(s, materials=mats), ray.origin,
                    ray.direction, pixel, FRAME)
        assert out.grad_fn.name().startswith("_SoaTrace")
    with pytest.raises(ValueError):
        tfg.make_fast_kajiya(scene, SALT, 2, backward="xla")
