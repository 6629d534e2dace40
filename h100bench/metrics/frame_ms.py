"""The window's time over the frames completed in it (host clock, the
window closed by a synchronize)."""


def read(run):
    if run.unit != "frame":
        return None
    return 1e3 * run.window_s / run.iterations
