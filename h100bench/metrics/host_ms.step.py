"""Host time to enqueue one trainer step: the benchmark's own clock around
each ``step()`` call of the window, averaged.  Beside ``step_ms`` it shows
whether the host sets the pace."""


def read(run):
    if run.unit != "step":
        return None
    return 1e3 * sum(run.host_s) / len(run.host_s)
