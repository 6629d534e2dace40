"""Host time per frame in the program's ``rvpt.frame.wait`` span: the wait
in ``Renderer.draw`` for the frame before last, the host's slack (near 0
when the host sets the pace)."""

from h100bench.spans import for_run


def read(run):
    s = for_run(run, "frame")
    return None if s is None else s.host_ms("rvpt.frame.wait")
