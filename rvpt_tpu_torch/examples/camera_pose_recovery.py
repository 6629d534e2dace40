"""Camera pose recovery by gradient descent through the renderer (mirror of
``examples/camera_pose_recovery.py``).

The camera's leaves are differentiable: gradients flow camera ->
camera_matrix -> generate_rays -> the integrator.  Interior camera
gradients are exact (held against finite differences in
``tests/test_torch_camera_grad.py``); edge and visibility transport is out
of scope, so a path-traced radiance MSE between poses, dominated by
silhouette, horizon and bounce-flip terms, does not converge.  Pose from a
DEPTH target is fully interior for a silhouette-free framing: the depth
render is deterministic and smooth in the pose, and recovery converges to
machine precision.  That is the formulation shown here.

    python -m rvpt_tpu_torch.examples.camera_pose_recovery
    python -m rvpt_tpu_torch.examples.camera_pose_recovery --device cpu \\
        --size 16x16
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--size", default="64x64", help="film WxH")
    p.add_argument("--steps", type=int, default=300)
    args = p.parse_args(argv)

    import torch

    from .. import FilmConfig, RenderSettings, resolve_device
    from ..models import camera as camera_mod
    from ..models.integrators import eval_integrator
    from ..render import _INTEGRATOR_SITE, _pixel_grid
    from ..scene import builtin

    dev = resolve_device(args.device)
    w, h = (int(v) for v in args.size.lower().split("x"))
    cfg = FilmConfig(width=w, height=h)
    settings = RenderSettings(max_bounces=1)
    scene, _ = builtin.sphere_plane(aspect=cfg.aspect, device=dev)
    pixel, xs, ys = _pixel_grid(cfg, dev)
    cx = (xs.to(torch.float32) + 0.5) / cfg.width
    cy = 1.0 - (ys.to(torch.float32) + 0.5) / cfg.height

    def depth_image(translation, rotation):
        cam = camera_mod.Camera.create(aspect=cfg.aspect, fov=55.0, device=dev)
        cam = dataclasses.replace(cam, translation=translation, rotation=rotation)
        ray = camera_mod.generate_rays(cam, cx, cy)
        return eval_integrator(2, scene, ray, pixel, 0, settings, _INTEGRATOR_SITE)

    # Ground-truth pose: close to the sphere so it fills the frame
    # (silhouette-free).
    t_true = torch.tensor([0.0, 0.0, 2.6], device=dev)
    r_true = torch.zeros(3, device=dev)
    with torch.no_grad():
        target = depth_image(t_true, r_true)

    t = (t_true + torch.tensor([0.12, -0.09, -0.18], device=dev)).requires_grad_(True)
    opt = torch.optim.Adam([t], lr=1e-2)
    print(f"initial pose error: {(t - t_true).abs().detach().cpu().numpy()}")
    for i in range(args.steps):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean(torch.square(depth_image(t, r_true) - target))
        loss.backward()
        opt.step()
        if i % 50 == 0:
            print(f"step {i:3d}  loss {loss.item():.3e}  "
                  f"err {float((t.detach() - t_true).abs().max()):.5f}")
    err = (t - t_true).abs().detach().cpu().numpy()
    print(f"final pose error: {err}  (loss {loss.item():.3e})")
    if err.max() >= 5e-3:
        sys.exit(f"camera pose not recovered: error {err.max():.5f} >= 5e-3")
    print("camera pose recovered.")
    return float(err.max())


if __name__ == "__main__":
    main()
