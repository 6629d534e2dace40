"""Device time per frame of the operations launched under the program's
``rvpt.frame.ema`` span: the film's EMA (``ops/film.accumulate`` in
``render.render_frame``)."""

from h100bench.spans import for_run


def read(run):
    s = for_run(run, "frame")
    return None if s is None else s.device_ms("rvpt.frame.ema")
