"""K1's (``path_kernel``) device time per frame in the traced window."""

from h100bench.trace import matcher


def read(run):
    if run.trace is None or run.unit != "frame":
        return None
    us = run.trace.device_us(matcher(("path_kernel",)))
    return us / run.trace.iterations / 1e3 if us else None
