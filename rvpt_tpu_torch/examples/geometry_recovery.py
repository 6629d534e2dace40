"""Geometry recovery: fit a sphere's radius by gradient descent through the
path tracer, the trainer's "spheres" group (mirror of
``examples/geometry_recovery.py``).

The scene is a mirror sphere under the gradient sky: the reflected sky
colour varies continuously with the radius-dependent normal field, so the
interior pathwise gradient (the paired trace's ``sph_radius`` cotangent)
carries a strong, correctly signed signal.  A Lambert sphere would not
converge this way: its radius signal is silhouette growth, a visibility
gradient that pathwise estimators cannot see.  Radius and depth couple
weakly through angular size, so the recovered (radius, center z) pair may
trade off a few percent against truth.

    python -m rvpt_tpu_torch.examples.geometry_recovery
    python -m rvpt_tpu_torch.examples.geometry_recovery --device cpu \\
        --size 16x16 --steps 5
"""

from __future__ import annotations

import argparse


def mirror_scene(radius: float, device):
    from ..scene.scene import SceneBuilder

    b = SceneBuilder()
    mir = b.add_material(albedo=(0.95, 0.95, 0.95), kind=1)
    b.add_sphere((0.0, 0.0, 3.0), radius, mir)
    return b.build(device)


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--size", default="48x48", help="film WxH")
    p.add_argument("--steps", type=int, default=120)
    args = p.parse_args(argv)

    from .. import FilmConfig, RenderSettings, resolve_device
    from ..models.camera import Camera
    from ..render import render_sample_chw
    from ..train import inverse

    dev = resolve_device(args.device)
    w, h = (int(v) for v in args.size.lower().split("x"))
    cfg = FilmConfig(width=w, height=h)
    cam = Camera.create(aspect=cfg.aspect, fov=60.0, device=dev)
    settings = RenderSettings(max_bounces=2, style="standard")

    true_radius = 1.0
    target = render_sample_chw(mirror_scene(true_radius, dev), cam, settings,
                               cfg, 0)
    scene_rec, losses, _ = inverse.recover(
        mirror_scene(0.7, dev), cam, settings, cfg, None, target,
        steps=args.steps, learning_rate=2e-2, groups=("spheres",), log_every=20)
    got = float(scene_rec.sph_radius[0])
    cz = float(scene_rec.sph_center[0, 2])
    print(f"recovered radius {got:.3f} (true {true_radius}), "
          f"center z {cz:.3f} (true 3.0), "
          f"angular size {got / cz:.4f} (true {true_radius / 3.0:.4f})")
    return abs(got - true_radius)


if __name__ == "__main__":
    main()
