"""Device kernels, memcpys and memsets per frame in the traced window."""


def read(run):
    if run.trace is None or run.unit != "frame":
        return None
    return run.trace.count() / run.trace.iterations
