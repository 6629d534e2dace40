"""Device time per trainer step of the operations that are not the port's
hand-written kernels (rvpt_tpu_torch/csrc/): PyTorch's kernels (autograd,
the replay, Adam), copies and memsets."""

from h100bench.trace import matcher

CSRC_KERNELS = ("path_kernel", "bwd_kernel", "table_sum_kernel",
                "closest_hit_kernel", "primary_kernel", "walk_count_kernel",
                "hart_kernel", "bigmesh_kernel", "bigmesh_hart_kernel",
                "march_kernel", "gather_kernel", "segsum_kernel", "round_kernel",
                "stats_sum_kernel", "stats_scan_kernel")


def read(run):
    if run.trace is None or run.unit != "step":
        return None
    ours = matcher(CSRC_KERNELS)
    return run.trace.device_us(lambda n: not ours(n)) / run.trace.iterations / 1e3
