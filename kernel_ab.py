"""Before/after timings of the redesigned kernels on one NVIDIA card: the
row forms of K1 and B3 (their row search), the BVH forms of K1 and B3 (their walk, and the big-mesh route, B5's function
folded into one K1 or B3 launch per frame), B4 (the Hart march) and K2
(the whole-chain pullback), B6 (the big-mesh Hart march), B7's segment
sum, K1's counting instances (``stats``) and B8, for the tree of rvpt_tpu_torch at ``--tree`` (the checkout root by
default; a parent commit unpacked by ``git archive`` into a gitignored
directory for "before").  It drives only entry points that every tree of
the port has: ``PathTracer.trace_hart``, ``launch_path_kernel``,
``launch_bwd_kernel``, ``Renderer.draw``, ``BigMeshTracer.trace`` and
``.trace_hart``, ``replay_soa.launch_segsum``, ``make_fast_kajiya`` and
``inverse.recover``, ``launch_path_stats`` and ``launch_closest_hit``.

    python3 kernel_ab.py [--tree DIR] [--label NAME]

Run it for both trees in one call, in turns (parent, change, change,
parent), and compare only within that call.  Each run builds its tree's
kernels from that tree's ``csrc/`` into that tree's ``build/``.
Every run times every section.  Prints:

* rows: K1's and B3's row forms on the Cornell box at 1080p x 4 bounces,
  standard, camera rays made in the kernels: K1 Kajiya, Whitted, Cook,
  its full and hits-only collect instances, B3 in modes 0-6 (AO 4
  probes), each launch's time (CUDA events, two runs of 20) and its
  device time (torch.profiler); the Kajiya and AO frames of hart_soup's
  600- and 1,000-triangle soups likewise; the split-screen draw (AO,
  Whitted, Hart, Kajiya: wall and device time, the K1, B3 and B4 launches
  apart) and each of its quadrants' launches alone (its kernel pass on
  its pixel ids, as the draw makes it); the Cornell fwd+bwd step's device
  time, K1's collect launch and K2 apart;
* bigmesh: ``Renderer.draw`` on mesh_demo(5) at 1080p x 8, standard, in
  each mode 0-9 and the split-screen (AO, Whitted, Hart, Kajiya), the
  terrain_demo(225) Kajiya, AO and Whitted frames and rabbit's Kajiya and
  AO frames at 1024x512 x 8: wall time per frame (host clock over
  synchronised draws) and device time per frame from torch.profiler, with
  the device time of the K1, B3, B5 and B6 launches apart; K1's hits-only
  collect launch alone on mesh_demo(5) at 1080p x 8 (through
  ``BigMeshTracer.trace(collect_hits=True)``: CUDA events, and its device
  time); the 1080p Cornell Kajiya draw (4 bounces) as the control;
* steps: one mesh_demo(5) fwd+bwd step (1080p x 8, albedo, emission and
  vertices): its wall time (host clock over 5 synchronised steps after a
  warm-up step) and device time, its K1 and B5 launches apart; and
  ``inverse.recover`` on mesh_demo(3) at 1080p x 8 as chip_smoke.py
  phase 21 runs it (albedo and emission, two renders per step): wall
  time per step over 10 steps after a 2-step warm-up run, and one step's
  device time;
* B7: the segment sum on chip_smoke.py phase 17's three inputs
  (mesh_demo(5)'s 1080p bounce-2 ids with the replay's zero cotangents,
  the same ids with none zero, a 140,000-row table at 2,073,600
  pixel-coherent ids) and on the real ids and cotangents of the 7 segment
  sums of one mesh_demo(5) fwd+bwd step at 1080p x 8: per input the
  wrapper's time (CUDA events), the device time of its memset, summing
  kernel and rounding pass (torch.profiler), and ``index_add_``'s time;
  and the 7 segment sums' device time inside one such step;
* B6: the mesh_demo(5) Hart frame at 1920x1080 through
  ``BigMeshTracer.trace_hart``, its time per frame (CUDA events);
* B4: the Cornell box's Hart frame at 1920x1080 and rabbit's at 1024x512
  through ``PathTracer.trace_hart`` (CUDA events), and ``Renderer.draw``
  of the Cornell Hart frame and of the split-screen frame (AO, Whitted,
  Hart, Kajiya) at 1080p x 4 bounces, with the Kajiya frame's draw as a
  control that neither redesign touches (host clock over synchronised
  draws, and each draw's device time from torch.profiler: the split
  frame's wall time is the host's);
* K2: its launch alone on a captured 1080p x 4 Cornell record (K1's
  collect launch on the camera rays, g = 1/(3N)), and its device time
  (the pullback and its table sum, torch.profiler) inside one Cornell
  fwd+bwd step at 1080p x 4 (``bench.py``'s mean-image loss over albedo
  and emission) and one rabbit step at 1024x512 x 8 (``backward="auto"``:
  K1's BVH-form records, then K2), beside each step's device time;
* stats: K1's counting instance (``launch_path_stats``) as chip_smoke.py
  phase 22 runs it, rabbit at 1024x512 and mesh_demo(3) at 1080p, 8
  bounces, Kajiya, Whitted and Cook, each beside the same launch without
  stats (the controls): CUDA events and device time, and digests of the
  counters and radiances;
* b8: B8 on the 1080p Cornell camera and bounce-2 rays and on the 300-,
  600- and 1,000-triangle soups (CUDA events, device time, a digest of t
  and the index), and the device time of ``recover``'s 8-frame target
  render;
* kernels: per function of path_kernel and closest_hit, its registers
  and stack and a digest of its SASS, so that two trees' instances
  compare by name.

The digests of two trees' runs compare bit for bit within one call.
The last line is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from chip_smoke import SEG_PARTS, cuda_ms, device_ms, hart_soup

# K2's device operations: the pullback and the partials' fixed-order sum.
BWD_PARTS = ("bwd_kernel", "table_sum_kernel")


# The big-mesh route's device operations: K1, B3, B5 and B6's march.
ROUTE_PARTS = ("path_kernel", "primary_kernel", "bigmesh_kernel", "march_kernel")


def mesh5_step(dev, hd, builtin):
    """One mesh_demo(5) fwd+bwd step at 1080p x 8 (standard, the mean
    image over albedo, emission and the vertices), a new frame per call."""
    import torch

    from rvpt_tpu_torch.core.types import Ray
    from rvpt_tpu_torch.ops.fast_grad import make_fast_kajiya
    from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays
    from rvpt_tpu_torch.train import inverse

    mesh5, cam5 = builtin.mesh_demo(5, aspect=hd.aspect, device=dev)
    pixel, xs, ys = _pixel_grid(hd, dev)
    ray = jittered_camera_rays(cam5, hd, pixel, xs, ys, 1, 0)
    ray = Ray(ray.origin.contiguous(), ray.direction.contiguous())
    trace = make_fast_kajiya(mesh5, 16, 8, style="standard")
    params = {k: x.detach().clone().requires_grad_(True) for k, x in
              inverse.trainable_params(mesh5, ("albedo", "emission", "vertices")).items()}
    frame = [0]

    def step():
        frame[0] += 1
        out = trace(inverse.apply_params(mesh5, params), ray.origin, ray.direction,
                    pixel, frame[0])
        return torch.autograd.grad(torch.mean(out), list(params.values()))

    return step


def segsum_inputs(dev, rs, pk, builtin, hd):
    """The segment sum's inputs: the three of phase 17, then the 7 of a
    mesh_demo(5) step (captured from the step's own calls), and the step."""
    import numpy as np
    import torch

    from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays

    inputs = {}
    mesh5, cam5 = builtin.mesh_demo(5, aspect=hd.aspect, device=dev)
    bt = pk.BigMeshTracer(mesh5)
    pixel, xs, ys = _pixel_grid(hd, dev)
    ray = jittered_camera_rays(cam5, hd, pixel, xs, ys, 1, 0)
    _, (fams, idxs) = bt.trace(pixel, ray.origin, ray.direction, 1, 16, 2,
                               collect_hits=True)
    t5 = mesh5.num_triangles
    idx5 = idxs[1].clamp(0, t5 - 1).to(torch.int32).contiguous()
    on_tri = fams[1] == 0
    n = hd.num_pixels
    scale = 1.0 / (3 * n)
    g5 = torch.from_numpy(np.random.default_rng(t5).normal(size=(9, n))
                          .astype(np.float32) * np.float32(scale)).to(dev)
    inputs["mesh5_bounce2"] = (idx5, (g5 * on_tri).contiguous(), t5)
    inputs["mesh5_bounce2_nonzero"] = (idx5, g5, t5)
    r = np.random.default_rng(17)
    t_huge = 140_000
    base = np.arange(n, dtype=np.int64) * t_huge // n
    huge_idx = np.clip(base + r.integers(-300, 300, n), 0, t_huge - 1)
    gh = torch.from_numpy(np.random.default_rng(t_huge).normal(size=(9, n))
                          .astype(np.float32) * np.float32(scale)).to(dev)
    inputs["rows_140000"] = (torch.from_numpy(huge_idx.astype(np.int32)).to(dev), gh,
                             t_huge)
    del fams, idxs, bt, ray
    step = mesh5_step(dev, hd, builtin)
    real, seen = rs.segsum, []

    def capture(idx, g, t_rows):
        seen.append((idx.clone(), g.clone(), int(t_rows)))
        return real(idx, g, t_rows)

    rs.segsum = capture
    try:
        step()
        torch.cuda.synchronize()
    finally:
        rs.segsum = real
    for k, item in enumerate(seen):
        inputs[f"mesh5_step_{k}"] = item
    return inputs, step


def draw_ms(scene, cam, cfg, modes, bounces, frames, names=()):
    """Renderer.draw with the four quadrants in ``modes`` -> (ms per frame
    on the host clock over synchronised draws after a warm-up draw, device
    ms per frame from torch.profiler, {name: device ms per frame of the
    operations whose names hold it})."""
    import torch

    from rvpt_tpu_torch import RenderSettings
    from rvpt_tpu_torch.renderer import Renderer

    keys = ("top_left_render_mode", "top_right_render_mode",
            "bottom_left_render_mode", "bottom_right_render_mode")
    r = Renderer(scene, cam, RenderSettings(max_bounces=bounces, style="standard",
                                            **dict(zip(keys, modes))), cfg)
    r.draw()
    r.flush()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        r.draw()
    r.flush()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / frames * 1e3
    parts, device = device_ms(r.draw, frames, names)
    return wall, device, parts


def hart_timings(dev, hd, pk, builtin):
    """B4's Hart frames through PathTracer.trace_hart, and the draws."""
    from rvpt_tpu_torch import FilmConfig

    out = {}
    for name, make, cfg in (("cornell_1080p", builtin.cornell_box, hd),
                            ("rabbit_1024x512", builtin.rabbit, FilmConfig(1024, 512))):
        scene, cam = make(aspect=cfg.aspect, device=dev)
        pt = pk.PathTracer(scene)
        cp = pk.camera_params(cam, cfg)
        n = cfg.num_pixels

        def frame(pt=pt, cp=cp, n=n, cam=cam):
            return pt.trace_hart(n, 1, cam_params=cp, cam_mode=cam.mode, jitter_salt=0)

        val = frame()
        out[name] = {"frame_ms": [cuda_ms(frame, 10) for _ in range(2)],
                     "value_mean": val[0].mean().item()}
    scene, cam = builtin.cornell_box(aspect=hd.aspect, device=dev)
    for name, modes in (("hart", (10,) * 4), ("split", (5, 7, 10, 9)),
                        ("kajiya", (9,) * 4)):
        out[f"draw_{name}_ms"], out[f"draw_{name}_device_ms"], _ = draw_ms(
            scene, cam, hd, modes, 4, 16)
    return out


def bigmesh_timings(dev, hd, builtin):
    """The BVH-form draws (mesh_demo(5) in modes 0-9 and the split-screen,
    terrain_demo(225) Kajiya, AO and Whitted, rabbit Kajiya and AO), K1's
    hits-only launch alone, and the Cornell Kajiya draw as the control."""
    from rvpt_tpu_torch import FilmConfig

    out = {}

    def entry(wall, device, parts):
        return {"wall_ms": wall, "device_ms": device,
                **{f"{k}_ms": v for k, v in parts.items()}}

    scene, cam = builtin.mesh_demo(5, aspect=hd.aspect, device=dev)
    for mode in range(10):
        out[f"mesh5_mode{mode}"] = entry(*draw_ms(scene, cam, hd, (mode,) * 4, 8, 8,
                                                  ROUTE_PARTS))
    out["mesh5_split"] = entry(*draw_ms(scene, cam, hd, (5, 7, 10, 9), 8, 4,
                                        ROUTE_PARTS))
    del scene
    scene, cam = builtin.terrain_demo(225, aspect=hd.aspect, device=dev)
    for mode, label in ((9, "kajiya"), (5, "ao"), (7, "whitted")):
        out[f"terrain_{label}"] = entry(*draw_ms(scene, cam, hd, (mode,) * 4, 8, 4,
                                                 ROUTE_PARTS))
    del scene
    rcfg = FilmConfig(1024, 512)
    scene, cam = builtin.rabbit(aspect=rcfg.aspect, device=dev)
    for mode, label in ((9, "kajiya"), (5, "ao")):
        out[f"rabbit_{label}"] = entry(*draw_ms(scene, cam, rcfg, (mode,) * 4, 8, 16,
                                                ROUTE_PARTS))
    del scene
    out["mesh5_hits_only"] = hits_only_timings(dev, hd, builtin)
    scene, cam = builtin.cornell_box(aspect=hd.aspect, device=dev)
    out["cornell_kajiya_control"] = entry(*draw_ms(scene, cam, hd, (9,) * 4, 4, 16,
                                                   ROUTE_PARTS))
    return out


def step_timings(dev, hd, builtin):
    """A mesh_demo(5) step's wall and device time, and recover on
    mesh_demo(3)."""
    out = {}
    step = mesh5_step(dev, hd, builtin)
    out["mesh5_step"] = {"wall_ms": wall_ms(step, 5)}
    parts, total = device_ms(step, 2, ROUTE_PARTS)
    out["mesh5_step"].update(device_ms=total, **{f"{k}_ms": v for k, v in parts.items()})
    del step
    out["mesh3_recover"] = recover_timings(dev, hd, builtin)
    return out


def hits_only_timings(dev, hd, builtin):
    """K1's hits-only collect launch alone on mesh_demo(5) at 1080p x 8,
    standard, on its camera rays: CUDA events per call, and the device
    time per call with K1's apart (the call also widens the hits)."""
    import torch

    from rvpt_tpu_torch.ops import pathkernel as pk
    from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays

    scene, cam = builtin.mesh_demo(5, aspect=hd.aspect, device=dev)
    bt = pk.BigMeshTracer(scene)
    pixel, xs, ys = _pixel_grid(hd, dev)
    ray = jittered_camera_rays(cam, hd, pixel, xs, ys, 1, 0)
    o, d = ray.origin.contiguous(), ray.direction.contiguous()

    def trace():
        return bt.trace(pixel, o, d, 1, 16, 8, "standard", collect_hits=True)

    trace()
    ms = [cuda_ms(trace, 10) for _ in range(2)]
    parts, total = device_ms(trace, 5, ROUTE_PARTS)
    del bt, scene, pixel, ray, o, d
    torch.cuda.empty_cache()
    return {"ms": ms, "device_ms": total, **{f"{k}_ms": v for k, v in parts.items()}}


def wall_ms(fn, iters):
    """ms per call of ``fn`` on the host clock over ``iters`` synchronised
    calls, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def recover_timings(dev, hd, builtin):
    """``inverse.recover`` on mesh_demo(3) at 1080p x 8 as chip_smoke.py
    phase 21 runs it: wall ms per step over 10 steps after a 2-step
    warm-up run, and the device time of one 1-step run (the caller's
    ROUTE_PARTS apart)."""
    import torch

    from rvpt_tpu_torch import RenderSettings
    from rvpt_tpu_torch.render import render_sample_fast_chw
    from rvpt_tpu_torch.train import inverse

    mesh3, cam3 = builtin.mesh_demo(3, aspect=hd.aspect, device=dev)
    st = RenderSettings(max_bounces=8, aa=1, style="standard")
    mats = mesh3.materials
    init = inverse.apply_params(mesh3, {
        "materials.albedo": torch.full_like(mats.albedo, 0.5),
        "materials.emission": mats.emission * 1.2})
    target = sum(render_sample_fast_chw(mesh3, cam3, st, hd, f) for f in range(4)) / 4

    def run(steps):
        return inverse.recover(init, cam3, st, hd, None, target, steps=steps,
                               learning_rate=3e-2)

    run(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(10)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 10 * 1e3
    parts, total = device_ms(lambda: run(1), 2, ROUTE_PARTS)
    return {"wall_ms_per_step": wall, "device_ms_per_step": total,
            **{f"{k}_ms": v for k, v in parts.items()}}


def bwd_timings(dev, hd, pk, builtin):
    """K2 alone on a captured 1080p Cornell record, and its device time
    inside a Cornell and a rabbit fwd+bwd step."""
    import torch

    from rvpt_tpu_torch import FilmConfig
    from rvpt_tpu_torch.ops.fast_grad import make_fast_kajiya
    from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays
    from rvpt_tpu_torch.train import inverse

    out = {}
    scene, cam = builtin.cornell_box(aspect=hd.aspect, device=dev)
    pt = pk.PathTracer(scene)
    pixel, xs, ys = _pixel_grid(hd, dev)
    ray = jittered_camera_rays(cam, hd, pixel, xs, ys, 1, 0)
    rays = tuple(c.contiguous() for c in (*ray.origin.T, *ray.direction.T))
    n = hd.num_pixels
    _, record = pk.launch_path_kernel(pt.tables, pt.counts, pixel, n, 1, 16, 4,
                                      "standard", rays=rays, collect=True)
    tables, counts = pk.pack_bwd(scene)
    g = torch.full((n, 3), 1.0 / (3 * n), device=dev)

    def k2():
        return pk.launch_bwd_kernel(tables, counts, record, pixel, 1, 16, "standard", g)

    k2()
    out["cornell_record_ms"] = [cuda_ms(k2, 20) for _ in range(2)]
    parts, total = device_ms(k2, 10, BWD_PARTS)
    out["cornell_record_device"] = {"total_ms": total, **parts}
    del record
    for name, cfg, nb in (("cornell_step", hd, 4),
                          ("rabbit_step", FilmConfig(1024, 512), 8)):
        if name == "rabbit_step":
            scene, cam = builtin.rabbit(aspect=cfg.aspect, device=dev)
            pixel, xs, ys = _pixel_grid(cfg, dev)
            ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, 1, 0)
        trace = make_fast_kajiya(scene, 16, nb, style="standard")
        params = {k: x.detach().clone().requires_grad_(True)
                  for k, x in inverse.trainable_params(scene).items()}
        frame = [0]

        def step(trace=trace, params=params, scene=scene, ray=ray, pixel=pixel):
            frame[0] += 1
            img = trace(inverse.apply_params(scene, params), ray.origin,
                        ray.direction, pixel, frame[0])
            return torch.autograd.grad(torch.mean(img), list(params.values()))

        parts, total = device_ms(step, 5, BWD_PARTS)
        out[name] = {"device_ms": total, **parts}
    return out


def b7_timings(rec, label, dev, rs, pk, builtin, hd):
    """B7's segment sum on its inputs and inside a mesh_demo(5) step."""
    import torch

    rec["b7"] = {}
    inputs, step = segsum_inputs(dev, rs, pk, builtin, hd)
    for name, (idx, g, t) in inputs.items():
        c = g.shape[0]
        ms = cuda_ms(lambda: rs.launch_segsum(idx, g, t), 20)
        parts, total = device_ms(lambda: rs.launch_segsum(idx, g, t), 10, SEG_PARTS)
        lib_ms = cuda_ms(
            lambda: torch.zeros((c, t), device=dev).index_add_(1, idx, g), 10)
        entry = {"columns": c, "rows": t, "n": int(idx.numel()), "ms": ms,
                 "device_ms": total, **{f"{k}_ms": v for k, v in parts.items()},
                 "index_add_ms": lib_ms}
        rec["b7"][name] = entry
        print(f"[ab] {label} B7 {name}: {json.dumps(entry)}")
    parts, total = device_ms(step, 2, SEG_PARTS)
    rec["b7"]["mesh5_step"] = {"device_ms": total,
                               **{f"{k}_ms": v for k, v in parts.items()}}
    print(f"[ab] {label} B7 in a mesh_demo(5) step: {json.dumps(rec['b7']['mesh5_step'])}")
    del inputs, step
    torch.cuda.empty_cache()


def b6_timings(dev, hd, pk, builtin):
    """B6's mesh_demo(5) Hart frame through BigMeshTracer.trace_hart."""
    import torch

    from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays

    scene, cam = builtin.mesh_demo(5, aspect=hd.aspect, device=dev)
    bt = pk.BigMeshTracer(scene)
    pixel, xs, ys = _pixel_grid(hd, dev)
    ray = jittered_camera_rays(cam, hd, pixel, xs, ys, 1, 0)
    o, d = ray.origin.contiguous(), ray.direction.contiguous()
    val = bt.trace_hart(pixel, o, d)
    out = {"frame_ms": [cuda_ms(lambda: bt.trace_hart(pixel, o, d), 3) for _ in range(2)],
           "value_mean": val[0].mean().item()}
    del bt, scene, pixel, ray, o, d, val
    torch.cuda.empty_cache()
    return out


# K1's and K2's device operations in the Cornell fwd+bwd step.
STEP_PARTS = ("path_kernel", "bwd_kernel", "table_sum_kernel")


def launch_ms(fn, name):
    """One launch ``fn``: CUDA events per call (two runs of 20) and the
    device time per call of the operations whose names hold ``name``."""
    fn()
    ms = [cuda_ms(fn, 20) for _ in range(2)]
    parts, total = device_ms(fn, 10, (name,))
    return {"ms": ms, "device_ms": parts[name], "all_device_ms": total}


def row_timings(dev, hd, pk, builtin):
    """K1's and B3's row forms at 1080p x 4 bounces, standard, camera rays
    made in the kernels: K1 Kajiya, Whitted, Cook, the full collect and
    the hits-only collect instance, B3 in modes 0-6 (AO 4 probes) on the
    Cornell box; the Kajiya and AO frames of hart_soup's 600- and
    1,000-triangle soups; the split-screen draw (AO, Whitted, Hart,
    Kajiya) and each quadrant's launch alone; and the Cornell fwd+bwd
    step's device time (K1's collect launch and K2 apart)."""
    import torch

    from rvpt_tpu_torch import RenderSettings
    from rvpt_tpu_torch.ops.fast_grad import make_fast_kajiya
    from rvpt_tpu_torch.render import (_pixel_grid, _rect_pixels, _split_partition,
                                       _trace_mode_kernel, jittered_camera_rays)
    from rvpt_tpu_torch.train import inverse

    out, n = {}, hd.num_pixels
    scene, cam = builtin.cornell_box(aspect=hd.aspect, device=dev)
    soups = [("soup600", *hart_soup(dev, 600, hd)), ("soup1000", *hart_soup(dev, 1000, hd))]
    for name, sc, cm in [("cornell", scene, cam)] + soups:
        pt = pk.PathTracer(sc)
        kw = dict(cam_params=pk.camera_params(cm, hd), cam_mode=cm.mode, jitter_salt=0)
        integs = ("kajiya", "whitted", "cook") if name == "cornell" else ("kajiya",)
        for integ in integs:
            out[f"{name}_{integ}"] = launch_ms(lambda pt=pt, kw=kw, integ=integ: (
                pk.launch_path_kernel(pt.tables, pt.counts, None, n, 1, 16, 4,
                                      "standard", integ=integ, **kw)), "path_kernel")
        if name == "cornell":
            for collect in (True, "hits"):
                out[f"cornell_collect_{collect}"] = launch_ms(
                    lambda pt=pt, kw=kw, collect=collect: pk.launch_path_kernel(
                        pt.tables, pt.counts, None, n, 1, 16, 4, "standard",
                        collect=collect, **kw), "path_kernel")
        for mode in range(7) if name == "cornell" else (5,):
            out[f"{name}_mode{mode}"] = launch_ms(
                lambda pt=pt, kw=kw, mode=mode: pk.launch_primary_kernel(
                    pt.tables, pt.counts, None, n, 1, 16, mode, 4 if mode == 5 else 1,
                    **kw), "primary_kernel")
        del pt
    wall, device, parts = draw_ms(scene, cam, hd, (5, 7, 10, 9), 4, 16,
                                  ("path_kernel", "primary_kernel", "hart_kernel"))
    out["cornell_split_draw"] = {"wall_ms": wall, "device_ms": device,
                                 **{f"{k}_ms": v for k, v in parts.items()}}
    split = RenderSettings(max_bounces=4, style="standard", top_left_render_mode=5,
                           top_right_render_mode=7, bottom_left_render_mode=10,
                           bottom_right_render_mode=9)
    pt, cp = pk.PathTracer(scene), pk.camera_params(cam, hd)
    for m, rect in _split_partition(hd, split):
        pix = _rect_pixels(*rect, hd.width, dev)
        kernel = ("hart_kernel" if m == 10 else "primary_kernel" if m in pk.PRIMARY_MODES
                  else "path_kernel")
        out[f"cornell_split_quadrant_mode{m}"] = launch_ms(
            lambda m=m, pix=pix: _trace_mode_kernel(pt, cam, split, cp, pix, 5, 0, m), kernel)
    pixel, xs, ys = _pixel_grid(hd, dev)
    ray = jittered_camera_rays(cam, hd, pixel, xs, ys, 1, 0)
    trace = make_fast_kajiya(scene, 16, 4, style="standard")
    params = {k: x.detach().clone().requires_grad_(True)
              for k, x in inverse.trainable_params(scene).items()}
    frame = [0]

    def step():
        frame[0] += 1
        img = trace(inverse.apply_params(scene, params), ray.origin, ray.direction,
                    pixel, frame[0])
        return torch.autograd.grad(torch.mean(img), list(params.values()))

    parts, total = device_ms(step, 5, STEP_PARTS)
    out["cornell_step"] = {"device_ms": total, **{f"{k}_ms": v for k, v in parts.items()}}
    return out


def digest(*tensors):
    """sha256 (first 16 hex digits) of the tensors' bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def stats_timings(dev, hd, pk, builtin):
    """K1's counting instance as chip_smoke.py phase 22 runs it
    (``launch_path_stats``: rabbit at 1024x512 and mesh_demo(3) at 1080p,
    8 bounces, reference, camera rays passed in, Kajiya, Whitted and
    Cook), each beside the same launch without stats: CUDA events per call
    (two runs of 10), the device time of the path kernel and of the
    summing kernel, and the digests of the counters and of both radiances."""
    import torch

    from rvpt_tpu_torch import FilmConfig
    from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays

    out = {}
    frame, salt, nb = 3, 16, 8
    for name, cfg, make in (
            ("rabbit", FilmConfig(1024, 512), builtin.rabbit),
            ("mesh3", hd, lambda aspect, device: builtin.mesh_demo(3, aspect=aspect,
                                                                   device=device))):
        scene, cam = make(aspect=cfg.aspect, device=dev)
        pt = pk.PathTracer(scene)
        pixel, xs, ys = _pixel_grid(cfg, dev)
        ray = jittered_camera_rays(cam, cfg, pixel, xs, ys, frame, 0)
        rays = tuple(c.contiguous() for c in (*ray.origin.T, *ray.direction.T))
        n = cfg.num_pixels
        for integ in ("kajiya", "whitted", "cook"):
            def counted(pt=pt, pixel=pixel, rays=rays, n=n, integ=integ):
                return pk.launch_path_stats(pt.tables, pt.counts, pt.tree, pt.cull, pixel,
                                            n, frame, salt, nb, "reference", rays=rays,
                                            integ=integ)

            def plain_k1(pt=pt, pixel=pixel, rays=rays, n=n, integ=integ):
                return pk.launch_path_kernel(pt.tables, pt.counts, pixel, n, frame, salt,
                                             nb, "reference", rays=rays, integ=integ,
                                             tree=pt.tree)

            rgb, agg = counted()
            bare = plain_k1()
            entry = {"counters": digest(agg), "rgb": digest(rgb), "rgb_without": digest(bare),
                     "listed": agg[0].sum().item(), "still": agg[2].sum().item()}
            for label, fn in (("stats", counted), ("without", plain_k1)):
                fn()
                entry[f"{label}_ms"] = [cuda_ms(fn, 10) for _ in range(2)]
                parts, total = device_ms(fn, 5, ("path_kernel", "stats_sum_kernel"))
                entry[f"{label}_device_ms"] = parts["path_kernel"]
                if label == "stats":
                    entry["sum_device_ms"] = parts["stats_sum_kernel"]
            out[f"{name}_{integ}"] = entry
        del pt, scene, rays, ray
        torch.cuda.empty_cache()
    return out


def b8_timings(dev, hd, pk, builtin):
    """B8 (``launch_closest_hit``) on the 1080p Cornell camera rays and
    bounce-2 rays (K1's collect record, 4 bounces, rays passed in) and on
    hart_soup's 300-, 600- and 1,000-triangle soups' camera rays: CUDA
    events per call (two runs of 20), device time, and the digest of t and
    the index; and the device time of ``recover``'s target render, 8
    frames of the plain path at 1080p x 4 bounces (``render_sample_chw``,
    32 B8 launches), B8's share apart."""
    import torch

    from rvpt_tpu_torch import RenderSettings
    from rvpt_tpu_torch.ops import intersect_pk as ipk
    from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays, render_sample_chw

    out, inf = {}, float("inf")
    scene, cam = builtin.cornell_box(aspect=hd.aspect, device=dev)
    pt = pk.PathTracer(scene)
    pixel, xs, ys = _pixel_grid(hd, dev)
    ray = jittered_camera_rays(cam, hd, pixel, xs, ys, 0, 0)
    rays = tuple(c.contiguous() for c in (*ray.origin.T, *ray.direction.T))
    _, rec = pk.launch_path_kernel(pt.tables, pt.counts, pixel, hd.num_pixels, 1, 16, 4,
                                   "standard", rays=rays, collect=True)
    packed = ipk.pack_triangles(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    cases = {"cornell_camera": (ray.origin.contiguous(), ray.direction.contiguous(), packed),
             "cornell_bounce2": (rec.fields[1, 0:3].T.contiguous(),
                                 rec.fields[1, 3:6].T.contiguous(), packed)}
    del rec
    for n_tri in (300, 600, 1000):
        sscene, scam = hart_soup(dev, n_tri, hd)
        sray = jittered_camera_rays(scam, hd, pixel, xs, ys, 0, 0)
        cases[f"soup{n_tri}"] = (sray.origin.contiguous(), sray.direction.contiguous(),
                                 ipk.pack_triangles(sscene.tri_v0, sscene.tri_v1,
                                                    sscene.tri_v2))
    for name, (o, d, tri) in cases.items():
        def b8(o=o, d=d, tri=tri):
            return ipk.launch_closest_hit(o, d, tri, 0.0, inf)

        t, idx = b8()
        iters = 20 if tri.shape[0] < 100 else 5
        parts, _ = device_ms(b8, iters, ("closest_hit_kernel",))
        out[name] = {"digest": digest(t, idx), "hits": int((idx >= 0).sum().item()),
                     "ms": [cuda_ms(b8, iters) for _ in range(2)],
                     "device_ms": parts["closest_hit_kernel"]}
    st = RenderSettings(max_bounces=4, aa=1, style="standard")

    def target():
        return sum(render_sample_chw(scene, cam, st, hd, f) for f in range(8)) / 8

    img = target()
    parts, total = device_ms(target, 2, ("closest_hit_kernel",))
    out["recover_target"] = {"digest": digest(img), "device_ms": total,
                             "closest_hit_ms": parts["closest_hit_kernel"]}
    return out


def kernel_record(build):
    """Per kernel function of path_kernel and closest_hit, as this tree
    built them: registers and stack (``cuobjdump -res-usage``) and a
    digest of its SASS without addresses (``cuobjdump -sass``), so two
    trees' instances compare by name."""
    import hashlib
    import re

    from chip_smoke import demangle

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    rec = {}
    for name in ("path_kernel", "closest_hit"):
        lib = str(build._lib_path(name))
        res = subprocess.run([tool, "-res-usage", lib], capture_output=True, text=True,
                             check=True, timeout=300).stdout
        usage, cur = {}, None
        for line in res.splitlines():
            m = re.search(r"Function (\S+):", line)
            cur = m.group(1) if m else cur
            m = re.search(r"REG:(\d+) STACK:(\d+)", line)
            if m and cur:
                usage[cur] = (int(m.group(1)), int(m.group(2)))
        sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        code, cur = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = code.setdefault(m.group(1), [])
                continue
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
            if m and cur is not None:
                cur.append(m.group(1).strip())
        names = demangle(set(usage) | set(code))
        for mangled in sorted(set(usage) | set(code)):
            body = "\n".join(code.get(mangled, []))
            reg, stack = usage.get(mangled, (None, None))
            rec[names.get(mangled, mangled)] = {
                "registers": reg, "stack": stack,
                "sass": hashlib.sha256(body.encode()).hexdigest()[:16]}
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default=None)
    a = ap.parse_args()
    tree = os.path.abspath(a.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    from rvpt_tpu_torch import FilmConfig
    from rvpt_tpu_torch.ops import build
    from rvpt_tpu_torch.ops import pathkernel as pk
    from rvpt_tpu_torch.ops import replay_soa as rs
    from rvpt_tpu_torch.scene import builtin

    got_tree = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(pk.__file__))))
    if got_tree != tree:
        raise SystemExit(f"kernel_ab: imported {got_tree}, not {tree}")
    label = a.label or os.path.basename(tree)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[ab] {label}: tree {tree} [{smi}]")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.build_all(("bigmesh_hart", "replay_lookup", "bigmesh_kernel", "path_kernel",
                     "primary_kernel", "hart_kernel", "bwd_kernel", "closest_hit"))
    print(f"[ab] {label}: built in {time.perf_counter() - t0:.1f} s")
    rec = {"label": label, "card": smi}
    hd = FilmConfig(1920, 1080)

    rec["rows"] = row_timings(dev, hd, pk, builtin)
    for k, v in rec["rows"].items():
        print(f"[ab] {label} rows {k}: {json.dumps(v)}")
    torch.cuda.empty_cache()
    rec["bigmesh"] = bigmesh_timings(dev, hd, builtin)
    for k, v in rec["bigmesh"].items():
        print(f"[ab] {label} bigmesh {k}: {json.dumps(v)}")
    torch.cuda.empty_cache()
    rec["steps"] = step_timings(dev, hd, builtin)
    for k, v in rec["steps"].items():
        print(f"[ab] {label} steps {k}: {json.dumps(v)}")
    torch.cuda.empty_cache()
    b7_timings(rec, label, dev, rs, pk, builtin, hd)
    rec["b6"] = b6_timings(dev, hd, pk, builtin)
    print(f"[ab] {label} B6: {json.dumps(rec['b6'])}")
    rec["b4"] = hart_timings(dev, hd, pk, builtin)
    print(f"[ab] {label} B4: {json.dumps(rec['b4'])}")
    rec["k2"] = bwd_timings(dev, hd, pk, builtin)
    print(f"[ab] {label} K2: {json.dumps(rec['k2'])}")
    torch.cuda.empty_cache()
    rec["stats"] = stats_timings(dev, hd, pk, builtin)
    for k, v in rec["stats"].items():
        print(f"[ab] {label} stats {k}: {json.dumps(v)}")
    torch.cuda.empty_cache()
    rec["b8"] = b8_timings(dev, hd, pk, builtin)
    for k, v in rec["b8"].items():
        print(f"[ab] {label} b8 {k}: {json.dumps(v)}")
    rec["kernels"] = kernel_record(build)
    for k, v in rec["kernels"].items():
        print(f"[ab] {label} kernel {k}: {json.dumps(v)}")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
