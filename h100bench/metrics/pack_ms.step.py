"""Host time per trainer step in the program's ``rvpt.pack`` spans: the
scene's tables packed each time a tracer is built (``PathTracer``)."""

from h100bench.spans import for_run


def read(run):
    s = for_run(run, "step")
    return None if s is None else s.host_ms("rvpt.pack")
