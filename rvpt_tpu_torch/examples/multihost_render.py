"""Multi-process rendering launcher (mirror of
``examples/multihost_render.py``).

Run one copy per process.  Under ``torchrun`` the rendezvous comes from
its environment; otherwise pass rank 0's address and this process's rank
(the JAX example's three flags).  Every process renders its contiguous
slice of the film's pixel ids (``parallel.sharded._padded_grid``) on its
device, the slices are gathered on rank 0 (``gather_film_to_host``), which
writes the PNG.  The scene is replicated and RNG streams are keyed by the
global pixel id, so the assembled image is the single-process render bit
for bit.  Two ranks on the CPU:

    python -m rvpt_tpu_torch.examples.multihost_render --device cpu \\
        --coordinator 127.0.0.1:9781 --num-processes 2 --process-id 0 &
    python -m rvpt_tpu_torch.examples.multihost_render --device cpu \\
        --coordinator 127.0.0.1:9781 --num-processes 2 --process-id 1
    torchrun --nproc-per-node 4 -m rvpt_tpu_torch.examples.multihost_render
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 (from torchrun's environment when omitted)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--backend", default=None,
                   help="nccl (the card's default) or gloo (the CPU's; also "
                        "several ranks on one card)")
    p.add_argument("--size", default="256x128", help="film WxH")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--out", default="out/multihost.png")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from .. import FilmConfig, RenderSettings, resolve_device
    from ..parallel.distributed import gather_film_to_host, initialize_distributed
    from ..parallel.sharded import _padded_grid
    from ..render import render_pixels
    from ..scene import builtin
    from ..utils.image import write_png

    dev = resolve_device(args.device)
    initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                           device=dev, backend=args.backend)
    try:
        w, h = (int(v) for v in args.size.lower().split("x"))
        cfg = FilmConfig(width=w, height=h)
        settings = RenderSettings(max_bounces=4)
        scene, camera = builtin.cornell_box(aspect=cfg.aspect, device=dev)

        rank, world = dist.get_rank(), dist.get_world_size()
        # Equal slices (all_gather needs equal shapes): ceil(n / world) ids
        # per rank, the last padded with wrapped ids dropped after the gather.
        pixel, xs, ys = _padded_grid(cfg, world, rank, dev)
        per = pixel.shape[0]
        print(f"process {rank}/{world}: pixels [{rank * per}, {(rank + 1) * per}) "
              f"on {dev}")
        acc = torch.zeros((per, 3), device=dev)
        for f in range(args.frames):
            sample = render_pixels(scene, camera, settings, cfg, f, pixel, xs, ys)
            acc = (acc * f + sample) / (f + 1)  # the reference's EMA

        full = gather_film_to_host(acc)
        if full is not None:
            write_png(args.out, full[:cfg.num_pixels].reshape(h, w, 3))
            print(f"wrote {args.out}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
