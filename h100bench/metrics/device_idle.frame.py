"""The device's idle share of the traced window of frames: 1 - (union of
device intervals) / (traced window), in %."""


def read(run):
    if run.trace is None or run.unit != "frame":
        return None
    return 100.0 * run.trace.idle_share()
