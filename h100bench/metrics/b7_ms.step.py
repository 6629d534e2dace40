"""B7's device time per trainer step: the SoA replay's gather, segment sum
and rounding kernels (rvpt_tpu_torch/csrc/replay_lookup.cu)."""

from h100bench.trace import matcher


def read(run):
    if run.trace is None or run.unit != "step":
        return None
    us = run.trace.device_us(matcher(("gather_kernel", "segsum_kernel", "round_kernel")))
    return us / run.trace.iterations / 1e3 if us else None
