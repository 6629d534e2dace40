"""Where the display frame's time goes, on one NVIDIA card.

    python3 profile_slice.py [--width 1920] [--height 1080] [--bounces 4]
                             [--frames 20] [--repeats 3]

Drives ``Renderer.draw`` of the Cornell box (style standard) through the
CUDA path kernel and prints:

* wall ms/frame without the profiler, timed with CUDA events over
  ``--frames`` draws, ``--repeats`` times;
* from one torch.profiler trace of ``--frames`` draws: device time per
  frame, the path kernel's part of it, device operations and host-to-device
  copies per frame by name, the device's idle share of the traced window
  (1 - union of device intervals / window), and an estimate of the idle
  share without the profiler (1 - device time / unprofiled wall time).

The last line is one JSON object with every number.  The trace is written
to out/profile_slice_trace.json.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: no CUDA device")
    from torch.profiler import ProfilerActivity, profile, record_function

    from rvpt_tpu_torch import FilmConfig, RenderSettings
    from rvpt_tpu_torch.renderer import Renderer
    from rvpt_tpu_torch.scene import builtin

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    cfg = FilmConfig(a.width, a.height)
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device=dev)
    r = Renderer(scene, cam, RenderSettings(max_bounces=a.bounces, style="standard"), cfg)
    for _ in range(3):
        r.draw()
    r.flush()

    wall_ms = []
    for _ in range(a.repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(a.frames):
            r.draw()
        stop.record()
        r.flush()
        stop.synchronize()
        wall_ms.append(start.elapsed_time(stop) / a.frames)
    print(f"[wall] {a.width}x{a.height} x {a.bounces} bounces: "
          f"{[round(v, 4) for v in wall_ms]} ms/frame over {a.repeats} x {a.frames} "
          f"draws, unprofiled [{smi}]")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("profile_slice.frames"):
            for _ in range(a.frames):
                r.draw()
            r.flush()
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "out"), exist_ok=True)
    trace_path = os.path.join(here, "out", "profile_slice_trace.json")
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
    k1_ev = [e for e in dev_ev if "path_kernel" in e["name"]]
    k1_us = sum(e["dur"] for e in k1_ev)
    by_name = Counter(e["name"] for e in dev_ev)
    h2d = sum(1 for e in dev_ev if "HtoD" in e["name"])

    rec = {
        "shape": [a.width, a.height, a.bounces], "frames": a.frames,
        "card": smi, "wall_ms_per_frame": wall_ms,
        "traced_window_ms_per_frame": (span_end - w0) / 1e3 / a.frames,
        "device_ms_per_frame": dev_us / 1e3 / a.frames,
        "path_kernel_ms_per_frame": k1_us / 1e3 / a.frames,
        "path_kernel_share_of_device": k1_us / dev_us,
        "path_kernel_launches": len(k1_ev),
        "device_ops_per_frame": len(dev_ev) / a.frames,
        "h2d_copies_per_frame": h2d / a.frames,
        "device_idle_share": 1.0 - busy / (span_end - w0),
        # The profiler slows the host, so the traced window overstates idle
        # time; this estimate holds the traced device time against the
        # unprofiled wall time of the same frames.
        "device_idle_share_unprofiled_est":
            1.0 - dev_us / 1e3 / a.frames / min(wall_ms),
        "device_ops": {k: v / a.frames for k, v in by_name.most_common()},
    }
    for k, v in rec.items():
        if k not in ("device_ops", "card", "shape", "frames"):
            print(f"[profile] {k}: {v}")
    for name, per_frame in rec["device_ops"].items():
        print(f"[profile] per frame {per_frame:g} x {name[:100]}")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
