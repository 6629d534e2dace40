"""torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start, in MiB."""


def read(run):
    return run.peak_bytes / 2**20 if run.peak_bytes else None
