"""Inverse rendering demo: recover the Cornell box's wall albedos and light
emission by gradient descent through the path tracer (mirror of
``examples/inverse_rendering.py``).

A ground-truth render is the target; the optimizer starts from gray walls
and a dimmed light and converges by pixel-MSE gradients that flow through
intersection, shading and the Monte-Carlo estimator.  Under ``torchrun``
(``WORLD_SIZE`` set) every rank joins one ``(tiles, spp)`` mesh and the
target and every step are sharded; otherwise one device renders.

    python -m rvpt_tpu_torch.examples.inverse_rendering
    torchrun --nproc-per-node 4 -m rvpt_tpu_torch.examples.inverse_rendering
    python -m rvpt_tpu_torch.examples.inverse_rendering --device cpu \\
        --size 16x16 --steps 3
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--size", default="96x96", help="film WxH")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--frames", type=int, default=8, help="frames averaged into the target")
    p.add_argument("--out-dir", default="out")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from .. import FilmConfig, RenderSettings, resolve_device
    from ..render import render_sample_chw
    from ..scene import builtin
    from ..train import inverse
    from ..utils.image import write_png

    dev = resolve_device(args.device)
    w, h = (int(v) for v in args.size.lower().split("x"))
    cfg = FilmConfig(width=w, height=h)
    settings = RenderSettings(max_bounces=4, aa=1, style="standard")
    scene_true, camera = builtin.cornell_box(aspect=cfg.aspect, device=dev)

    mesh = None
    if "WORLD_SIZE" in os.environ:
        from ..parallel.distributed import initialize_distributed
        from ..parallel.mesh import make_mesh
        from ..parallel.sharded import render_sample_sharded

        initialize_distributed(device=dev)
        mesh = make_mesh(device=dev)

    # Ground truth: average several frames to tame Monte-Carlo noise.
    target = torch.zeros((3, cfg.height, cfg.width), device=dev)
    for f in range(args.frames):
        if mesh is not None:
            img = render_sample_sharded(scene_true, camera, settings, cfg, f, mesh)
        else:
            img = render_sample_chw(scene_true, camera, settings, cfg, f)
        target = target + img / args.frames

    # Perturb: gray walls, dimmed light.
    mats = scene_true.materials
    scene_init = inverse.apply_params(scene_true, {
        "materials.albedo": torch.full_like(mats.albedo, 0.5),
        "materials.emission": mats.emission * 0.25})

    scene_rec, losses, _ = inverse.recover(
        scene_init, camera, settings, cfg, mesh, target,
        steps=args.steps, learning_rate=3e-2, log_every=50)
    # The per-step loss compares a single noisy sample with the target, so
    # it carries the Monte-Carlo variance (which grows as the emission
    # brightens toward truth): judge convergence by the parameter errors.
    err = {}
    for k in ("albedo", "emission"):
        start = (getattr(scene_init.materials, k) - getattr(mats, k)).abs()
        final = (getattr(scene_rec.materials, k) - getattr(mats, k)).abs()
        err |= {f"{k}_max": float(final.max()), f"{k}_mean": float(final.mean()),
                f"{k}_mean_start": float(start.mean())}
    print(f"final loss {losses[-1]:.6f}")
    print(f"max albedo error {err['albedo_max']:.3f}  "
          f"max emission error {err['emission_max']:.3f}")
    print(f"mean albedo error {err['albedo_mean_start']:.4f} -> {err['albedo_mean']:.4f}, "
          f"mean emission error {err['emission_mean_start']:.4f} -> "
          f"{err['emission_mean']:.4f}")

    if mesh is None or dist.get_rank() == 0:
        img = render_sample_chw(scene_rec, camera, settings, cfg, 999)
        for name, x in (("inverse_target.png", target), ("inverse_recovered.png", img)):
            write_png(os.path.join(args.out_dir, name),
                      np.moveaxis(x.detach().cpu().numpy(), 0, -1))
    if mesh is not None:
        dist.destroy_process_group()
    return err


if __name__ == "__main__":
    main()
