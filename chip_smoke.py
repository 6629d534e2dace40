"""On-card smoke run of rvpt_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one NVIDIA card (Hopper, sm_90a) and nvcc; there is no CPU path.
Phases, each of which raises on failure:

1. device: the card, its power limit, torch/CUDA/nvcc versions;
2. build: the path kernel from rvpt_tpu_torch/csrc at first use;
3. kernel vs plain: the CUDA kernel against its plain PyTorch version on
   the card, Cornell box at 1920x1080 (rays passed in: 3 bounces, both
   styles, >= 99.5% of pixel channels within 1e-4; rays made in the
   kernel: 4 bounces, standard, per-channel film mean within 1% and
   >= 99.5% of pixel channels within 1e-4), and
   both timed with CUDA events at the display shape;
4. goldens, for the record: the kernel route against
   tests/goldens/cornell_kajiya.png (printed, not asserted: the kernel and
   the XLA path that made the golden round differently);
5. the slice: Renderer.draw x16 of the Cornell box at 1920x1080, 4
   bounces, style standard, through the kernel (its launch count must
   rise by exactly 16), then save_image.

Prints the kernel record as a JSON line, then, last, one JSON line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters):
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")

    from rvpt_tpu_torch import FilmConfig, RenderSettings
    from rvpt_tpu_torch.ops import build
    from rvpt_tpu_torch.ops import pathkernel as pk
    from rvpt_tpu_torch.ops.film import chw_to_hwc, to_srgb_u8
    from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays
    from rvpt_tpu_torch.renderer import Renderer
    from rvpt_tpu_torch.scene import builtin
    from rvpt_tpu_torch.utils.image import read_png

    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "out")  # gitignored render outputs
    dev = torch.device("cuda")
    # Full-f32 matmuls (camera rays) on both sides of every comparison.
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    nvcc_v = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | nvcc {nvcc_v} | "
          f"python {sys.version.split()[0]}")

    # ---- 2. build
    t0 = time.perf_counter()
    pk._path_lib()
    info = build.BUILD_INFO["path_kernel"]
    print(f"[build] path_kernel built in {info['seconds']:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s): {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")

    # ---- 3. kernel vs plain on the card
    cfg = FilmConfig(1920, 1080)
    n = cfg.num_pixels
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)
    pt = pk.PathTracer(scene)
    pixel, xs, ys = _pixel_grid(cfg, dev)
    ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, 0, 0)
    rays = tuple(c.contiguous() for c in (
        ray.origin[:, 0], ray.origin[:, 1], ray.origin[:, 2],
        ray.direction[:, 0], ray.direction[:, 1], ray.direction[:, 2]))
    cam_params = pk.camera_params(cam, cfg)
    for style in ("reference", "standard"):
        got = pk.launch_path_kernel(pt.tables, pt.counts, pixel, n, 1, 16, 3,
                                    style, rays=rays)
        want = pk.trace_plain(pt.tables, pt.counts, pixel, 1, 16, 3, style,
                              rays=rays)
        torch.cuda.synchronize()
        close = torch.isclose(got, want, rtol=1e-4, atol=1e-4).float().mean().item()
        err = (got - want).abs().max().item()
        print(f"[kernel-vs-plain] rays in, 3 bounces, {style}: "
              f"{close:.6f} of channels within 1e-4 (bar 0.995), max |err| {err:.3g}")
        check(close >= 0.995, f"kernel disagrees with plain ({style}): {close:.6f}")

    main_kw = dict(rays=None, cam_params=cam_params, cam_mode=cam.mode,
                   jitter_salt=0)

    def kernel_frame():
        return pk.launch_path_kernel(pt.tables, pt.counts, None, n, 1, 16, 4,
                                     "standard", **main_kw)

    def plain_frame():
        return pk.trace_plain(pt.tables, pt.counts, pixel, 1, 16, 4, "standard",
                              **main_kw)

    got, want = kernel_frame(), plain_frame()
    torch.cuda.synchronize()
    close = torch.isclose(got, want, rtol=1e-4, atol=1e-4).float().mean().item()
    max_err = (got - want).abs().max().item()
    mean_k, mean_p = got.mean(dim=1), want.mean(dim=1)
    rel = ((mean_k - mean_p).abs() / mean_p.abs()).max().item()
    print(f"[kernel-vs-plain] camera rays in kernel, 4 bounces, standard: film "
          f"means {[round(v, 6) for v in mean_k.tolist()]} vs "
          f"{[round(v, 6) for v in mean_p.tolist()]} (max rel {rel:.3g}, bar 0.01); "
          f"{close:.6f} of channels within 1e-4; max |err| {max_err:.3g}")
    check(torch.isfinite(got).all().item(), "kernel film has non-finite values")
    check(rel <= 0.01, f"kernel film mean off the plain version's by {rel:.3g}")
    # Per pixel as well: the means alone would not see a mirrored, shifted
    # or unjittered image from the kernel's own camera rays.
    check(close >= 0.995, f"kernel camera-ray film disagrees with plain: {close:.6f}")

    for _ in range(3):
        kernel_frame()
    ms = cuda_ms(kernel_frame, 20)
    plain_frame()
    plain_ms = cuda_ms(plain_frame, 3)
    rays_per_frame = n * 4
    print(f"[time] 1920x1080 x 4 bounces: kernel {ms:.4f} ms "
          f"({rays_per_frame / ms / 1e3:.1f} Mrays/s), plain {plain_ms:.4f} ms "
          f"({rays_per_frame / plain_ms / 1e3:.1f} Mrays/s) [{smi}]")

    # ---- 4. goldens, for the record
    gcfg = FilmConfig(64, 64)
    gscene, gcam = builtin.cornell_box(aspect=gcfg.aspect, device=dev)
    gr = Renderer(gscene, gcam, RenderSettings(max_bounces=4), gcfg)
    for _ in range(4):
        gr.draw()
    gr.flush()
    img = to_srgb_u8(chw_to_hwc(gr.film.accum)).cpu().numpy().astype(int)
    golden = read_png(os.path.join(here, "tests", "goldens", "cornell_kajiya.png"))
    off = (abs(img - golden.astype(int)) > 2).mean()
    print(f"[goldens] cornell_kajiya via the kernel: {off:.4%} of subpixels "
          f"more than 2 u8 steps off (recorded, not asserted; the CPU bar is 0.2%)")

    # ---- 5. the slice: Renderer.draw at 1080p through the kernel
    r = Renderer(scene, cam, RenderSettings(max_bounces=4, style="standard"), cfg)
    pk.launch_path_kernel.launches = 0
    r.draw()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(15):
        r.draw()
    r.flush()
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / 15 * 1e3
    launches = pk.launch_path_kernel.launches
    check(launches == 16, f"path kernel launched {launches} times in 16 draws")
    accum = r.film.accum
    check(r.film.frame == 16, f"film accumulated {r.film.frame} frames, not 16")
    check(bool(torch.isfinite(accum).all().item()), "film has non-finite values")
    check(accum.mean().item() > 0.01, "film is black")
    png = os.path.join(out_dir, "torch_cornell_1080p.png")
    r.save_image(png)
    check(read_png(png).shape == (1080, 1920, 3), "saved image has the wrong shape")
    st = r.stats()
    print(f"[slice] Renderer.draw x16, 1920x1080, 4 bounces, standard: "
          f"{frame_ms:.4f} ms/frame, {r.rays_per_frame / frame_ms / 1e3:.1f} Mrays/s "
          f"(timer avg {st['avg_ms']:.4f} ms); kernel launches {launches}; "
          f"film mean {accum.mean().item():.6f}; plain version {plain_ms:.4f} ms/frame, "
          f"{r.rays_per_frame / plain_ms / 1e3:.1f} Mrays/s; saved {png} [{smi}]")

    print(json.dumps({"kernels": [{
        "name": "path_kernel", "route": "cuda",
        "source": "rvpt_tpu_torch/csrc/path_kernel.cu",
        "replaces": "rvpt_tpu/ops/pathkernel.py:1115",
        "launches": launches, "max_abs_err": max_err, "within_1e-4": close,
        "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
