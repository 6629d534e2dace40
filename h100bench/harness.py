"""One run of one cell, driven by data: ``BENCHMARK.json`` names the cell's
configuration, traffic and metrics; each lives in a file of its own that
this module finds by that name:

* ``configs/<config>.json``: the scene (``scenes/<maker>.py`` makes it),
  film, bounces, style, ``source``, ``reduced``, ``assumed``;
* ``traffic/<traffic>.json``: the loop (``loops/<loop>.py``) and its
  parameters;
* ``metrics/<metric>.py``: a reader, ``read(run)``, of the run's records
  or of the traced window, returning None where it finds nothing;
* ``limits/<workload>.json``: the limit of each number the check
  compares.

A run: set-up (kernels from the checkout's cache, the scene made on the
device from the seed, the loop's own shapes warmed up), the window of
``seconds``, with ``trace`` a profiled stretch of the loop after it, then
the program's state freed and the check against the reference.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level modules no run may hold: the JAX package and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "rvpt_tpu")


def load_spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "h100bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Run:
    """What a run leaves for the metric readers."""

    def __init__(self, workload, loop, setup_s, iterations, window_s, host_s,
                 peak_bytes, intervals_ms, counts):
        self.workload, self.unit = workload, loop.unit
        self.setup_s, self.iterations, self.window_s = setup_s, iterations, window_s
        self.host_s, self.peak_bytes = host_s, peak_bytes
        self.intervals_ms = intervals_ms
        self.counts = counts  # (triangles, spheres, planes) of the scene
        self.trace = None
        self.traced_frames = []
        self._loop = loop
        self._census = None

    def census(self) -> list:
        """Per traced iteration, the reference's count of its work (worked
        out once, after the check)."""
        if self._census is None:
            self._census = self._loop.census(self.traced_frames)
        return self._census


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def profile(loop, iterations: int, path: Path, cuda: bool):
    """Trace ``iterations`` of the loop (after one untraced warm iteration
    inside the profiler) and reduce the trace."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx, record_function

    from .trace import SPAN, Trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with prof_ctx(activities=acts) as prof:
        loop.iterate()
        loop.drain()
        for _ in range(iterations):
            with record_function(SPAN + loop.unit):
                loop.iterate()
        loop.drain()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return Trace.load(path, loop.unit)


def card_lines() -> list:
    """The card's nvidia-smi name and power limit, torch and CUDA."""
    import subprocess

    lines = [f"torch {torch.__version__}, CUDA {torch.version.cuda}"]
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        lines.insert(0, "card: " + out.stdout.strip())
    except (OSError, subprocess.TimeoutExpired) as e:
        lines.insert(0, f"card: nvidia-smi failed: {e}")
    return lines


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             device="cuda", film=None, log=None, control=False) -> dict:
    """Run the cell once; returns the result line as a dict (its ``checks``
    last).  ``film`` (width, height) replaces the configuration's film: the
    CPU tests' small runs.  ``control`` reads the checks with the
    reference in bfloat16 in the program's place (``calibrate.py``)."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    spec = load_spec()
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg = load_json("configs", cell["config"])
    if film is not None:
        cfg = dict(cfg, film=list(film))
    traffic = load_json("traffic", cell["traffic"])
    limits = load_json("limits", workload)
    loops = importlib.import_module(f"h100bench.loops.{traffic['loop']}")
    maker = importlib.import_module(f"h100bench.scenes.{cfg['scene']['maker']}")
    cuda = torch.device(device).type == "cuda"

    def phase(what):
        log(f"[set-up] {time.perf_counter() - t_start:.3f} s: {what}")

    if cuda:
        from . import program

        program.build_kernels()
        phase("kernels built or found")
    loop = loops.Loop(cfg, traffic, seed, device, maker.build)
    loop.log = phase
    phase("scene made")
    loop.setup()
    _sync(cuda)
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    host, ends = [], []
    t0 = time.perf_counter()
    while True:
        h0 = time.perf_counter()
        loop.iterate()
        h1 = time.perf_counter()
        host.append(h1 - h0)
        ends.append(h1 - t0)
        if h1 - t0 >= seconds:
            break
    loop.drain()
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    s = loop.scene
    run = Run(workload, loop, t0 - t_start, len(host), t1 - t0, host, peak,
              loop.intervals_ms(),
              (s.v0.shape[0], s.sph_radius.shape[0], s.pln_d.shape[0]))
    # Iterations per fifth of the window: how steady the rate was.
    fifths = [0] * 5
    for e in ends:
        fifths[min(4, int(5 * e / (t1 - t0)))] += 1
    log(f"[window] {workload} seed {seed}: {len(host)} {loop.unit}s in "
        f"{t1 - t0:.4f} s, set-up {t0 - t_start:.4f} s, peak {peak} B; "
        f"per fifth of the window {fifths}")
    if trace:
        k = int(traffic["trace_iterations"])
        run.trace = profile(loop, k, HERE / "out" / f"{workload}.trace.json", cuda)
        run.traced_frames = loop.frames(k)
    loop.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    readings = loop.control() if control else loop.check()
    log(f"[check] {time.perf_counter() - t_check:.2f} s")

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec[kind]:
        if not applies(m, workload):
            continue
        value = load_reader(m["name"])(run)
        if value is None:
            log(f"[metric] {m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": max(setup_peak, peak)}
    out = {"correct": all(readings[k] <= limits[k] for k in limits),
           "attempted": run.iterations, "failed": 0, "metrics": metrics,
           "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_us / 1e6
        dev["window_s"] = run.trace.window_us / 1e6
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    return out
