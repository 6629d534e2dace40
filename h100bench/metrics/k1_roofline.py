"""K1's share of its roofline on the traced frames: the sum of each
frame's bound (``bounds.k1_bound_s``, on the reference's census of that
frame's work) over K1's device time in those frames, in %."""

from h100bench.bounds import k1_bound_s
from h100bench.trace import matcher


def read(run):
    if run.trace is None or run.unit != "frame":
        return None
    us = run.trace.device_us(matcher(("path_kernel",)))
    if not us:
        return None
    bound = sum(k1_bound_s(c, run.counts) for c in run.census())
    return 100.0 * bound / (us / 1e6)
