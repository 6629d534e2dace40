"""Host time per trainer step in the program's ``rvpt.step.render_a`` and
``rvpt.step.render_b`` spans: the step's two renders."""

from h100bench.spans import for_run


def read(run):
    s = for_run(run, "step")
    return None if s is None else s.host_ms("rvpt.step.render_a", "rvpt.step.render_b")
