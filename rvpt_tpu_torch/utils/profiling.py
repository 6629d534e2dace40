"""Profiling: device traces and derived throughput (mirror of
``rvpt_tpu/utils/profiling.py``).

The reference's only profiling surface is a host frame timer with a
50-frame rolling window (src/rvpt/timer.cpp:35-40) plus object names for
external profilers (vk_util.h:31-64).  Here ``torch.profiler`` records the
card's kernels and the host's ops into a Chrome trace, with named regions
around host phases.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block (the card's kernels
    too when a card is present) and write it to ``log_dir/trace.json``
    (chrome://tracing, Perfetto).  Yields the profiler, whose
    ``key_averages()`` sums the time by op and kernel.

        with device_trace("out/trace") as prof:
            img = render_sample_fast_chw(...)
            torch.cuda.synchronize()
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region inside a device trace."""
    return torch.profiler.record_function(name)


def mrays_per_second(width: int, height: int, bounces: int, spp: int,
                     seconds: float) -> float:
    """Throughput of one frame: film rays x bounce upper bound / time.

    Every bounce slot counts as a ray (the reference's dispatch does the
    same work per pixel regardless of early termination), so numbers are
    comparable across scenes.
    """
    if seconds <= 0.0:
        return float("inf")
    return width * height * spp * bounces / seconds / 1e6


@dataclass
class StepProfile:
    """Per-step host timing ring, the Timer's profiling-oriented sibling.

    Records (name -> seconds) phase durations per step; ``summary()`` gives
    mean/min/max per phase over the retained window.
    """

    window: int = 50
    _steps: list = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        if not self._steps or name in self._steps[-1]:
            self._steps.append({})
            if len(self._steps) > self.window:
                self._steps.pop(0)
        self._steps[-1][name] = dt

    def summary(self) -> dict:
        out: dict = {}
        for step in self._steps:
            for name, dt in step.items():
                out.setdefault(name, []).append(dt)
        return {
            name: {
                "mean_s": sum(v) / len(v),
                "min_s": min(v),
                "max_s": max(v),
                "count": len(v),
            }
            for name, v in out.items()
        }
