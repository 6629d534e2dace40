"""95th percentile, over every frame of the window, of the device time
between the ends of successive frames (a CUDA event recorded after each
``Renderer.draw`` returns): the stutter a viewer sees."""

import statistics


def read(run):
    if run.unit != "frame" or len(run.intervals_ms) < 20:
        return None
    return statistics.quantiles(run.intervals_ms, n=100)[94]
