"""Camera-parameter gradients of rvpt_tpu_torch end to end (mirror of
tests/test_camera_grad.py:94 and :114; :72, the paired trace against
autograd, is tests/test_torch_fast_grad.py's).

The camera's leaves are tensors, and the chain camera -> camera_matrix ->
generate_rays -> integrator couples them to the image.  Central finite
differences check the absolute scale of autograd through the plain
Kajiya path on a Lambert-only scene (sphere_plane, 32x32, 2 bounces,
standard; rtol 0.08, tests/test_camera_grad.py:106), and pose recovery on
a depth image converges (250 Adam steps at lr 1e-2 from a 0.1-0.15
offset: loss below 1e-6 of its start, pose within 5e-3).
"""

import dataclasses

import numpy as np
import pytest
import torch

from rvpt_tpu_torch import FilmConfig, RenderSettings
from rvpt_tpu_torch.core import rng
from rvpt_tpu_torch.models import camera as camera_mod
from rvpt_tpu_torch.models.integrators import eval_integrator, integrator_kajiya
from rvpt_tpu_torch.render import _INTEGRATOR_SITE, _JITTER_SITE, _pixel_grid
from rvpt_tpu_torch.scene import builtin

SETTINGS = RenderSettings(max_bounces=2, style="standard")
CFG = FilmConfig(width=32, height=32)


@pytest.fixture(scope="module")
def scene():
    return builtin.sphere_plane(aspect=1.0, device="cpu")[0]


def _loss(scene):
    """Mean Kajiya image as a function of (translation, fov)."""
    pixel, xs, ys = _pixel_grid(CFG, "cpu")
    ju, jv = rng.uniform2(pixel, 0, _JITTER_SITE)
    cx = (xs.to(torch.float32) + ju) / CFG.width
    cy = 1.0 - (ys.to(torch.float32) + jv) / CFG.height

    def loss(translation, fov):
        cam = dataclasses.replace(camera_mod.Camera.create(aspect=CFG.aspect, device="cpu"),
                                  translation=translation, fov=fov)
        ray = camera_mod.generate_rays(cam, cx, cy)
        return torch.mean(integrator_kajiya(scene, ray, pixel, 0, SETTINGS,
                                            salt_base=_INTEGRATOR_SITE))

    return loss


def test_camera_grads_match_finite_differences(scene):
    loss = _loss(scene)
    t0 = torch.tensor([0.05, -0.02, 0.1])
    fov0 = torch.tensor(90.0)
    t, f = t0.clone().requires_grad_(True), fov0.clone().requires_grad_(True)
    gt, gf = torch.autograd.grad(loss(t, f), (t, f))

    eps = 2e-3
    with torch.no_grad():
        fd_t = np.array([(float(loss(t0 + e, fov0)) - float(loss(t0 - e, fov0))) / (2 * eps)
                         for e in torch.eye(3) * eps], np.float32)
        fd_f = (float(loss(t0, fov0 + 0.1)) - float(loss(t0, fov0 - 0.1))) / 0.2
    np.testing.assert_allclose(gt.numpy(), fd_t, rtol=0.08, atol=2e-4)
    np.testing.assert_allclose(float(gf), fd_f, rtol=0.08, atol=2e-5)
    assert gt.abs().max() > 1e-5 and abs(float(gf)) > 1e-7  # the chain is live


def test_camera_pose_recovery_converges(scene):
    """Translation from a depth-image loss: a close-up (the sphere fills the
    film at fov 55 from z = 2.6) keeps the silhouette out of frame, so the
    interior gradient is the whole gradient."""
    pixel, xs, ys = _pixel_grid(CFG, "cpu")
    cx = (xs.to(torch.float32) + 0.5) / CFG.width
    cy = 1.0 - (ys.to(torch.float32) + 0.5) / CFG.height
    depth_settings = RenderSettings(max_bounces=1)

    def depth_image(translation):
        cam = dataclasses.replace(
            camera_mod.Camera.create(aspect=CFG.aspect, fov=55.0, device="cpu"),
            translation=translation)
        return eval_integrator(2, scene, camera_mod.generate_rays(cam, cx, cy), pixel,
                               0, depth_settings, _INTEGRATOR_SITE)

    def mse(t):
        return torch.mean(torch.square(depth_image(t) - target))

    t_true = torch.tensor([0.0, 0.0, 2.6])
    with torch.no_grad():
        target = depth_image(t_true)
    t = (t_true + torch.tensor([0.1, -0.08, -0.15])).requires_grad_(True)
    opt = torch.optim.Adam([t], lr=1e-2)
    with torch.no_grad():
        l0 = float(mse(t))
    for _ in range(250):
        opt.zero_grad(set_to_none=True)
        loss = mse(t)
        loss.backward()
        opt.step()
    err = float((t.detach() - t_true).abs().max())
    assert float(loss) < 1e-6 * l0, f"pose recovery stalled: {l0} -> {float(loss)}"
    assert err < 5e-3, f"recovered pose off by {err}"
