"""Profiling: device traces and the port's named spans (mirror of
``rvpt_tpu/utils/profiling.py``).

The reference's only profiling surface is a host frame timer with a
50-frame rolling window (src/rvpt/timer.cpp:35-40) plus object names for
external profilers (vk_util.h:31-64).  Here ``torch.profiler`` records the
card's kernels and the host's ops into a Chrome trace, and ``annotate``
names the host phases inside it: every span of the port goes through it.
"""

from __future__ import annotations

import contextlib
import os

import torch

# Prefix of every span the port records.
SPAN = "rvpt."

_NO_SPAN = contextlib.nullcontext()


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
    """A span ``rvpt.<name>`` of the trace that a ``torch.profiler``
    session is recording, in the same trace as the card's kernels (each
    launch inside it tied to its kernel by the trace's correlation id).
    With no session recording, one shared no-op context: entering a
    ``record_function`` costs about 10 µs on the host even then, this
    check under 1 µs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(SPAN + name)
    return _NO_SPAN
