"""Device time per frame of the operations launched under the program's
``rvpt.rays`` span: the camera rays made in PyTorch
(``render.jittered_camera_rays``)."""

from h100bench.spans import for_run


def read(run):
    s = for_run(run, "frame")
    return None if s is None else s.device_ms("rvpt.rays")
