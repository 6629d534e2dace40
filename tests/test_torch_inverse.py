"""The inverse-rendering trainer of rvpt_tpu_torch against rvpt_tpu.

On the CPU the trainer renders through the plain versions of the kernels.
Bars: parameter plumbing equal to JAX's; one torch.optim.Adam step equal
to one optax.adam step on the same gradients within rtol 1e-6 (optax adds
eps after the square root, as torch does); the gradient through the
EMA-accumulated film against central finite differences
(tests/test_inverse.py:197 bar).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rvpt_tpu.scene import builtin as jbuiltin
from rvpt_tpu.train import inverse as jinv
from rvpt_tpu_torch import FilmConfig, RenderSettings, convert
from rvpt_tpu_torch.models.camera import Camera
from rvpt_tpu_torch.render import render_sample_chw
from rvpt_tpu_torch.scene import builtin
from rvpt_tpu_torch.scene.materials import LAMBERT
from rvpt_tpu_torch.scene.scene import SceneBuilder
from rvpt_tpu_torch.train import inverse

ALL_GROUPS = tuple(inverse.PARAM_GROUPS)


def _scenes():
    js, jc = jbuiltin.cornell_box(aspect=1.5)
    ts, tc = builtin.cornell_box(aspect=1.5, device="cpu")
    # one plane, so the planes group has leaves
    b = SceneBuilder()
    m = b.add_material(albedo=(0.5, 0.5, 0.5))
    b.add_plane((0.0, 1.0, 0.0), -1.0, m)
    tp = b.build("cpu")
    js = dataclasses.replace(js, pln_normal=jnp.asarray([[0.0, 1.0, 0.0]]),
                             pln_d=jnp.asarray([-1.0]), pln_mat=jnp.asarray([0]))
    ts = dataclasses.replace(ts, pln_normal=tp.pln_normal, pln_d=tp.pln_d,
                             pln_mat=tp.pln_mat)
    return js, jc, ts, tc


def test_param_plumbing_matches_jax():
    """(g) trainable_params, apply_params, apply_camera and
    constrain_params against JAX's, for every group."""
    js, jc, ts, tc = _scenes()
    jp = jinv.trainable_params(js, ALL_GROUPS, jc)
    tp = inverse.trainable_params(ts, ALL_GROUPS, tc)
    assert list(jp) == list(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), err_msg=k)

    r = np.random.default_rng(0)
    new = {k: (np.asarray(v) * 1.7 + r.normal(0, 0.8, np.shape(v))).astype(np.float32)
           for k, v in jp.items()}
    js2 = jinv.apply_params(js, {k: jnp.asarray(v) for k, v in new.items()})
    jc2 = jinv.apply_camera(jc, {k: jnp.asarray(v) for k, v in new.items()})
    tnew = convert.params_from_numpy(new, "cpu")
    ts2 = inverse.apply_params(ts, tnew)
    tc2 = inverse.apply_camera(tc, tnew)
    for k in ("tri_v0", "tri_v1", "tri_v2", "sph_center", "sph_radius",
              "pln_normal", "pln_d"):
        np.testing.assert_array_equal(getattr(ts2, k).numpy(),
                                      np.asarray(getattr(js2, k)), err_msg=k)
    for k in ("albedo", "emission", "ior"):
        np.testing.assert_array_equal(getattr(ts2.materials, k).numpy(),
                                      np.asarray(getattr(js2.materials, k)))
    for k in ("translation", "rotation"):
        np.testing.assert_array_equal(getattr(tc2, k).numpy(),
                                      np.asarray(getattr(jc2, k)))

    want = jinv.constrain_params({k: jnp.asarray(v) for k, v in new.items()})
    got = inverse.constrain_params(tnew)
    assert got is tnew  # in place
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert (got["materials.albedo"] >= 0).all() and (got["materials.albedo"] <= 1).all()


@pytest.mark.parametrize("scale", [1e-2, 1e-8, 3e-9])
def test_adam_step_matches_optax(scale):
    """(h) One step of torch.optim.Adam (the trainer's optimizer, default
    betas and eps) against one optax.adam step on the same seeded
    gradients.  At gradients near eps its placement counts: optax and
    torch both add it after the square root.  optax rounds its bias
    correction 1 - 0.999^t to f32 (a relative 6e-6 of the step), so the
    parameters are held at rtol 1e-6 at the magnitudes of the ior group and
    the step itself at rtol 1e-5."""
    r = np.random.default_rng(1)
    p0 = r.uniform(1.0, 3.0, (6, 3)).astype(np.float32)
    g = (r.normal(size=(6, 3)) * scale).astype(np.float32)
    lr = 3e-2
    opt = optax.adam(lr)
    jp = jnp.asarray(p0)
    upd, _ = opt.update(jnp.asarray(g), opt.init(jp), jp)
    want = np.asarray(optax.apply_updates(jp, upd))
    p = torch.from_numpy(p0.copy()).requires_grad_(True)
    topt = torch.optim.Adam([p], lr=lr)
    assert topt.defaults["betas"] == (0.9, 0.999) and topt.defaults["eps"] == 1e-8
    p.grad = torch.from_numpy(g)
    topt.step()
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(p.detach().numpy() - p0, np.asarray(upd),
                               rtol=1e-5, atol=1e-7)
    assert np.abs(np.asarray(upd)).max() > 1e-3  # a real step at every scale


def test_ema_film_gradient_matches_finite_differences():
    """(i) d(loss on the 4-frame accumulated image)/d(albedo) by autograd
    through accumulate_frames against central finite differences."""
    cfg = FilmConfig(width=16, height=12)
    st = RenderSettings(max_bounces=2, style="standard")
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device="cpu")
    k = 4

    def render(p, frame):
        mats = dataclasses.replace(scene.materials, albedo=p)
        return render_sample_chw(dataclasses.replace(scene, materials=mats),
                                 cam, st, cfg, frame)

    def loss(p):
        img = inverse.accumulate_frames(render, cfg, p, 9, k)
        return torch.mean(torch.square(img))

    p0 = scene.materials.albedo.clone().requires_grad_(True)
    loss(p0).backward()
    g = p0.grad.numpy()
    assert np.abs(g).max() > 0
    eps = 1e-3
    with torch.no_grad():
        for f in np.argsort(-np.abs(g).ravel())[:3]:
            i, j = divmod(int(f), g.shape[1])
            e = torch.zeros_like(p0)
            e[i, j] = eps
            fd = (loss(p0 + e).item() - loss(p0 - e).item()) / (2 * eps)
            assert abs(g[i, j] - fd) < max(0.05 * abs(fd), 1e-4), (
                f"leaf ({i},{j}): grad {g[i, j]} vs fd {fd}")


def _emissive_scene(emission):
    b = SceneBuilder()
    b.add_material(albedo=(0.0, 0.0, 0.0), emission=emission, kind=LAMBERT)
    b.add_triangle((-4, -4, 3), (4, -4, 3), (0, 6, 3), 0)
    return b.build("cpu")


@pytest.mark.parametrize("fast", [True, False])
def test_recover_emission_direct(fast):
    """A directly visible emissive triangle: emission is recovered through
    the paired trace (fast) and through autograd of the integrator."""
    cfg = FilmConfig(width=16, height=16)
    st = RenderSettings(max_bounces=1, style="standard")
    cam = Camera.create(aspect=1.0, fov=90.0, device="cpu")
    true_em = (2.0, 1.0, 0.5)
    target = render_sample_chw(_emissive_scene(true_em), cam, st, cfg, 0)
    rec, losses, _ = inverse.recover(
        _emissive_scene((0.2, 0.2, 0.2)), cam, st, cfg, None, target,
        steps=100, learning_rate=5e-2, fast=fast)
    got = rec.materials.emission[0].numpy()
    assert np.allclose(got, true_em, atol=0.15), f"recovered {got}"
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_train_step_dual_estimator_and_options():
    """One fast step from dimmed emission raises it (the dual-buffer
    estimator points back toward the target); a JAX-only ``fast`` value
    and a mesh raise."""
    cfg = FilmConfig(width=16, height=16)
    st = RenderSettings(max_bounces=1, style="standard")
    cam = Camera.create(aspect=1.0, fov=90.0, device="cpu")
    scene = _emissive_scene((2.0, 2.0, 2.0))
    target = render_sample_chw(scene, cam, st, cfg, 0)
    step, opt = inverse.make_train_step(scene, cam, st, cfg, None, target)
    params = inverse.trainable_params(scene)
    dim = dict(params)
    dim["materials.emission"] = params["materials.emission"] * 0.3
    new, opt, loss = step(dim, opt, 0)
    assert torch.isfinite(loss)
    assert new["materials.emission"][0, 0] > dim["materials.emission"][0, 0]
    # the scene's own tensors are untouched
    assert torch.equal(scene.materials.emission, params["materials.emission"])
    with pytest.raises(ValueError):
        inverse.make_train_step(scene, cam, st, cfg, None, target, fast="interpret")
    with pytest.raises(TypeError, match="DeviceMesh"):
        inverse.make_train_step(scene, cam, st, cfg, object(), target)
