"""Debug and validation switches (mirror of ``rvpt_tpu/utils/debug.py``).

The reference's equivalents are Vulkan validation layers and sanitizers
in debug builds.  Here what remains useful is numeric validation (NaN
checks in autograd) and running the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def validation(nan_checks: bool = True):
    """The debug-build mode: autograd's anomaly mode, which raises where a
    backward pass produces NaN (``check_nan``) and names the forward op."""
    with torch.autograd.detect_anomaly(check_nan=nan_checks):
        yield


@contextlib.contextmanager
def interpret_kernels():
    """Route the tracers (``PathTracer``, ``BigMeshTracer``, the replay's
    lookups) to their plain PyTorch versions on any device for the block,
    the counterpart of running the Pallas kernels in the interpreter.
    Only a caller who enters it gets the plain versions; the kernels'
    launch counters stay where they were."""
    from ..ops.pathkernel import PLAIN_KERNELS

    token = PLAIN_KERNELS.set(True)
    try:
        yield
    finally:
        PLAIN_KERNELS.reset(token)
