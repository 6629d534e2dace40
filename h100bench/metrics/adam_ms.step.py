"""Host time per trainer step in the program's ``rvpt.step.adam`` span: the
optimizer's step."""

from h100bench.spans import for_run


def read(run):
    s = for_run(run, "step")
    return None if s is None else s.host_ms("rvpt.step.adam")
