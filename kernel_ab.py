"""Before/after timings of B6 (the big-mesh Hart march) and B7's segment
sum on one NVIDIA card, for the tree of rvpt_tpu_torch at ``--tree`` (the
checkout root by default; a parent commit unpacked by ``git archive``
into a gitignored directory for "before").  It drives only entry points
that every tree of the port has: ``BigMeshTracer.trace_hart``,
``replay_soa.launch_segsum`` and ``make_fast_kajiya``.

    python3 kernel_ab.py [--tree DIR] [--label NAME]

Run it for both trees in one call, in turns (parent, change, change,
parent), and compare only within that call.  Each run builds its tree's
kernels from that tree's ``csrc/`` into that tree's ``build/``.  Prints:

* B7: the segment sum on chip_smoke.py phase 17's three inputs
  (mesh_demo(5)'s 1080p bounce-2 ids with the replay's zero cotangents,
  the same ids with none zero, a 140,000-row table at 2,073,600
  pixel-coherent ids) and on the real ids and cotangents of the 7 segment
  sums of one mesh_demo(5) fwd+bwd step at 1080p x 8: per input the
  wrapper's time (CUDA events), the device time of its memset, summing
  kernel and rounding pass (torch.profiler), and ``index_add_``'s time;
  and the 7 segment sums' device time inside one such step;
* B6: the mesh_demo(5) Hart frame at 1920x1080 through
  ``BigMeshTracer.trace_hart``, its time per frame (CUDA events).

The last line is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from chip_smoke import SEG_PARTS, cuda_ms, device_ms


def segsum_inputs(dev, rs, pk, builtin, hd):
    """The segment sum's inputs: the three of phase 17, then the 7 of a
    mesh_demo(5) step (captured from the step's own calls), and the step."""
    import numpy as np
    import torch

    from rvpt_tpu_torch.core.types import Ray
    from rvpt_tpu_torch.ops.fast_grad import make_fast_kajiya
    from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays
    from rvpt_tpu_torch.train import inverse

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
    del fams, idxs, bt

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
    from rvpt_tpu_torch.render import _pixel_grid, jittered_camera_rays
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
    build.build_all(("bigmesh_hart", "replay_lookup", "bigmesh_kernel"))
    print(f"[ab] {label}: built in {time.perf_counter() - t0:.1f} s")
    rec = {"label": label, "card": smi, "b7": {}, "b6": {}}
    hd = FilmConfig(1920, 1080)

    # ---- B7
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

    # ---- B6
    scene, cam = builtin.mesh_demo(5, aspect=hd.aspect, device=dev)
    bt = pk.BigMeshTracer(scene)
    pixel, xs, ys = _pixel_grid(hd, dev)
    ray = jittered_camera_rays(cam, hd, pixel, xs, ys, 1, 0)
    o, d = ray.origin.contiguous(), ray.direction.contiguous()
    val = bt.trace_hart(pixel, o, d)
    rec["b6"] = {"frame_ms": [cuda_ms(lambda: bt.trace_hart(pixel, o, d), 3)
                              for _ in range(2)],
                 "value_mean": val[0].mean().item()}
    print(f"[ab] {label} B6: {json.dumps(rec['b6'])}")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
