"""K2's share of its roofline on the traced steps: the sum of each step's
bound (``bounds.k2_bound_s``, on the reference's census of the
differentiated render's record) over the device time of K2's two kernels
(``bwd_kernel``, ``table_sum_kernel``) in those steps, in %."""

from h100bench.bounds import k2_bound_s
from h100bench.trace import matcher


def read(run):
    if run.trace is None or run.unit != "step":
        return None
    us = run.trace.device_us(matcher(("bwd_kernel", "table_sum_kernel")))
    if not us:
        return None
    bound = sum(k2_bound_s(c) for c in run.census())
    return 100.0 * bound / (us / 1e6)
