"""Where the time goes, on one NVIDIA card: the display frame or the
training step.

    python3 profile_slice.py [--fwd-bwd] [--width 1920] [--height 1080]
                             [--bounces 4] [--frames 20] [--repeats 3]
                             [--scene cornell|rabbit|mesh3|mesh5|terrain]
                             [--mode 9] [--mesh]

Default mode drives ``Renderer.draw`` (style standard) of ``--scene`` (the
Cornell box by default; rabbit, mesh_demo(3), mesh_demo(5) or
terrain_demo(225)) in integrator ``--mode`` (Kajiya by default) through
the kernels.  ``--fwd-bwd`` drives a training step of ``--scene`` instead:
value and gradient of the mean image through ``make_fast_kajiya``.  On the
Cornell box that is the headline step (bench.py:63-90 on the port,
chip_smoke.py phase 9) over ``trainable_params`` (albedo, emission): camera
rays, K1 with records, K2 and its table sum, and the autograd glue.  On a
mesh it is the mesh step of bench.py:125-160 (chip_smoke.py phase 19) over
albedo, emission and the vertices: on a big mesh K1's hits-only collect
instance (one launch), then the SoA replay with the B7 gather and segment
sum; on rabbit K1's BVH form with records, then K2.  ``--mesh`` draws
the display frame through ``Renderer(mesh=...)`` on a world of one under
NCCL (``parallel.distributed.initialize_distributed`` on a free localhost
port, ``parallel.mesh.make_mesh(1, 1)``): the sharded path's collectives
show as the ``nccl`` part.  Prints:

* wall ms per frame or step without the profiler, timed with CUDA events
  over ``--frames`` iterations, ``--repeats`` times;
* from one torch.profiler trace of ``--frames`` iterations: device time
  per iteration, split by kernel (display: each kernel of the route and
  the rest;
  fwd+bwd: K1 with records, K2, K2's table sum, B5 (no step launches it
  since the big-mesh route's redesign), B7's gather, segment sum and its
  rounding pass, and the glue), device
  operations and host-to-device copies per iteration by name, the device's
  idle share of the traced window (1 - union of device intervals /
  window), and an estimate of the idle share without the profiler (1 -
  device time / unprofiled wall time);
* the host's CUDA runtime calls per iteration that can wait on the device
  or allocate (names holding Synchronize, Malloc, Free or Memcpy).

The last line is one JSON object with every number.  The trace is written
to out/profile_slice_trace.json (out/profile_fwd_bwd_trace.json with
--fwd-bwd).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import Counter

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


SCENES = {
    "cornell": lambda b, aspect, dev: b.cornell_box(aspect=aspect, device=dev),
    "rabbit": lambda b, aspect, dev: b.rabbit(aspect=aspect, device=dev),
    "mesh3": lambda b, aspect, dev: b.mesh_demo(3, aspect=aspect, device=dev),
    "mesh5": lambda b, aspect, dev: b.mesh_demo(5, aspect=aspect, device=dev),
    "terrain": lambda b, aspect, dev: b.terrain_demo(225, aspect=aspect, device=dev),
}


def _display(a, dev):
    """One display frame: ``Renderer.draw``; parts by kernel name (the
    first part whose key an event's name holds takes it)."""
    from rvpt_tpu_torch import FilmConfig, RenderSettings
    from rvpt_tpu_torch.renderer import Renderer
    from rvpt_tpu_torch.scene import builtin

    cfg = FilmConfig(a.width, a.height)
    scene, cam = SCENES[a.scene](builtin, cfg.aspect, dev)
    quads = ("top_left_render_mode", "top_right_render_mode",
             "bottom_left_render_mode", "bottom_right_render_mode")
    st = RenderSettings(max_bounces=a.bounces, style="standard",
                        **dict.fromkeys(quads, a.mode))
    mesh = None
    if a.mesh:
        from rvpt_tpu_torch.parallel.distributed import initialize_distributed
        from rvpt_tpu_torch.parallel.dryrun import free_port
        from rvpt_tpu_torch.parallel.mesh import make_mesh

        initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0)
        mesh = make_mesh(1, 1)
    r = Renderer(scene, cam, st, cfg, mesh=mesh)
    parts = {"path_kernel": ("path_kernel",), "primary_kernel": ("primary_kernel",),
             "bigmesh_hart": ("bigmesh_hart", "march_kernel"),
             "hart_kernel": ("hart_kernel",),
             "bigmesh_kernel": ("bigmesh_kernel",), "nccl": ("nccl",)}
    name = ("profile_slice_trace.json" if a.scene == "cornell" and a.mode == 9
            else f"profile_slice_{a.scene}_mode{a.mode}_trace.json")
    if a.mesh:
        name = name.replace("_trace.json", "_mesh_trace.json")
    return r.draw, r.flush, parts, name


def _fwd_bwd(a, dev):
    """One headline training step; parts by kernel name."""
    import torch

    from rvpt_tpu_torch import FilmConfig
    from rvpt_tpu_torch.core import rng
    from rvpt_tpu_torch.models import camera as camera_mod
    from rvpt_tpu_torch.ops.fast_grad import make_fast_kajiya
    from rvpt_tpu_torch.render import _pixel_grid
    from rvpt_tpu_torch.scene import builtin
    from rvpt_tpu_torch.train import inverse

    cfg = FilmConfig(a.width, a.height)
    scene, cam = SCENES[a.scene](builtin, cfg.aspect, dev)
    trace = make_fast_kajiya(scene, 16, a.bounces, style="standard")
    pixel, xs, ys = _pixel_grid(cfg, dev)
    groups = (("albedo", "emission") if scene.bvh is None
              else ("albedo", "emission", "vertices"))
    params = {k: x.detach().clone().requires_grad_(True)
              for k, x in inverse.trainable_params(scene, groups).items()}
    frame = [0]

    def step():
        ju, jv = rng.uniform2(pixel, 0, 0)
        cx = (xs.to(torch.float32) + ju) / cfg.width
        cy = 1.0 - (ys.to(torch.float32) + jv) / cfg.height
        ray = camera_mod.generate_rays(cam, cx, cy)
        s = inverse.apply_params(scene, params)
        frame[0] += 1
        loss = torch.mean(trace(s, ray.origin, ray.direction, pixel, frame[0]))
        return torch.autograd.grad(loss, list(params.values()))

    # Demangled or not, the B7 kernels' names end in "<name>_kernel(" or
    # hold its length-prefixed mangled form.
    parts = {"k1_collect": ("path_kernel",), "k2": ("bwd_kernel",),
             "k2_table_sum": ("table_sum_kernel",), "b5": ("bigmesh_kernel",),
             "b7_gather": ("::gather_kernel(", "13gather_kernelE"),
             "b7_segsum": ("::segsum_kernel(", "13segsum_kernelE"),
             "b7_round": ("::round_kernel(", "12round_kernelE")}
    name = ("profile_fwd_bwd_trace.json" if a.scene == "cornell"
            else f"profile_fwd_bwd_{a.scene}_trace.json")
    return step, torch.cuda.synchronize, parts, name


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fwd-bwd", action="store_true",
                    help="profile the training step instead of the display frame")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--scene", choices=sorted(SCENES), default="cornell",
                    help="the display frame's or the training step's scene")
    ap.add_argument("--mode", type=int, default=9,
                    help="the display frame's integrator mode (9: Kajiya)")
    ap.add_argument("--mesh", action="store_true",
                    help="draw through Renderer(mesh=...) on a world of one (NCCL)")
    a = ap.parse_args()
    if a.mesh and a.fwd_bwd:
        ap.error("--mesh profiles the display frame")

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: no CUDA device")
    from torch.profiler import ProfilerActivity, profile, record_function

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    mode = "fwd_bwd" if a.fwd_bwd else "display"
    run, flush, parts, trace_name = (_fwd_bwd if a.fwd_bwd else _display)(a, dev)
    unit = "step" if a.fwd_bwd else "frame"
    for _ in range(3):
        run()
    flush()

    wall_ms = []
    for _ in range(a.repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(a.frames):
            run()
        stop.record()
        flush()
        stop.synchronize()
        wall_ms.append(start.elapsed_time(stop) / a.frames)
    print(f"[wall] {mode}{' mesh' if a.mesh else ''} {a.scene} mode {a.mode} "
          f"{a.width}x{a.height} x {a.bounces} bounces: "
          f"{[round(v, 4) for v in wall_ms]} ms/{unit} over {a.repeats} x {a.frames} "
          f"iterations, unprofiled [{smi}]")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("profile_slice.frames"):
            for _ in range(a.frames):
                run()
            flush()
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "out"), exist_ok=True)
    trace_path = os.path.join(here, "out", trace_name)
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]

    window = [e for e in events if e.get("ph") == "X"
              and e.get("name") == "profile_slice.frames"
              and e.get("cat") == "user_annotation"]
    if len(window) != 1:
        raise RuntimeError(f"found {len(window)} frame windows in the trace")
    w0, w1 = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
    dev_ev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not dev_ev:
        raise RuntimeError("the trace holds no device operations")
    busy = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in dev_ev])
    span_end = max(w1, max(e["ts"] + e["dur"] for e in dev_ev))
    dev_us = sum(e["dur"] for e in dev_ev)
    per = a.frames
    part_us = dict.fromkeys(parts, 0.0)
    part_n = dict.fromkeys(parts, 0)
    for e in dev_ev:
        part = next((p for p, keys in parts.items()
                     if any(k in e["name"] for k in keys)), None)
        if part is not None:
            part_us[part] += e["dur"]
            part_n[part] += 1
    glue_us = dev_us - sum(part_us.values())
    by_name = Counter(e["name"] for e in dev_ev)
    h2d = sum(1 for e in dev_ev if "HtoD" in e["name"])
    runtime = Counter(e["name"] for e in events if e.get("ph") == "X"
                      and e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and w0 <= e["ts"] <= w1
                      and any(k in e["name"] for k in ("Synchronize", "Malloc",
                                                       "Free", "Memcpy")))

    rec = {
        "mode": mode, "mesh": a.mesh, "shape": [a.width, a.height, a.bounces], "iterations": per,
        "scene": a.scene, "integrator_mode": a.mode,
        "card": smi, f"wall_ms_per_{unit}": wall_ms,
        f"traced_window_ms_per_{unit}": (span_end - w0) / 1e3 / per,
        f"device_ms_per_{unit}": dev_us / 1e3 / per,
        **{f"{p}_ms_per_{unit}": us / 1e3 / per for p, us in part_us.items()},
        **{f"{p}_share_of_device": us / dev_us for p, us in part_us.items()},
        **{f"{p}_launches": part_n[p] for p in parts},
        f"other_device_ms_per_{unit}": glue_us / 1e3 / per,
        "other_share_of_device": glue_us / dev_us,
        f"device_ops_per_{unit}": len(dev_ev) / per,
        f"h2d_copies_per_{unit}": h2d / per,
        "device_idle_share": 1.0 - busy / (span_end - w0),
        # The profiler slows the host, so the traced window overstates idle
        # time; this estimate holds the traced device time against the
        # unprofiled wall time of the same work.
        "device_idle_share_unprofiled_est":
            1.0 - dev_us / 1e3 / per / min(wall_ms),
        f"runtime_calls_per_{unit}": {k: v / per for k, v in runtime.most_common()},
        "device_ops": {k: v / per for k, v in by_name.most_common()},
    }
    for k, v in rec.items():
        if k not in ("device_ops", "card", "shape", "iterations", "mode", "mesh",
                     "scene", "integrator_mode"):
            print(f"[profile] {k}: {v}")
    for name, n in rec["device_ops"].items():
        print(f"[profile] per {unit} {n:g} x {name[:100]}")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
