"""The examples of rvpt_tpu_torch (``rvpt_tpu_torch/examples``, mirrors of
``examples/*.py``) run as ``python -m`` modules on the CPU at tiny sizes,
all started together in one module fixture: inverse_rendering in one
process and in two ranks joined through torchrun's environment
(``env://``, a (2, 1) mesh), geometry_recovery, camera_pose_recovery (to
convergence, its own bar: pose error < 5e-3), and multihost_render in two
ranks joined by the JAX example's three flags, whose assembled PNG must be
the single-process EMA render's bit for bit."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from rvpt_tpu_torch import FilmConfig, RenderSettings
from rvpt_tpu_torch.parallel.dryrun import free_port
from rvpt_tpu_torch.render import _pixel_grid, render_pixels
from rvpt_tpu_torch.scene import builtin
from rvpt_tpu_torch.utils.image import read_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MULTIHOST = dict(size=(32, 16), frames=2)


def _runs(out, port, torchrun_port):
    """name -> [(python arguments, extra environment)], one per process."""
    def m(module, *args):
        return ["-m", f"rvpt_tpu_torch.examples.{module}", "--device", "cpu", *args]

    w, h = MULTIHOST["size"]
    inv = ("--size", "16x16", "--steps", "3", "--frames", "2", "--out-dir")
    torchrun = [{"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(torchrun_port),
                 "WORLD_SIZE": "2", "RANK": str(r)} for r in range(2)]
    return {
        "inverse_rendering": [(m("inverse_rendering", *inv, str(out / "inv")), {})],
        "inverse_rendering_2": [(m("inverse_rendering", *inv, str(out / "inv2")), env)
                                for env in torchrun],
        "geometry_recovery": [(m("geometry_recovery", "--size", "16x16", "--steps", "5"),
                               {})],
        "camera_pose_recovery": [(m("camera_pose_recovery", "--size", "16x16"), {})],
        "multihost_render": [(m("multihost_render", "--coordinator", f"127.0.0.1:{port}",
                                "--num-processes", "2", "--process-id", str(r),
                                "--size", f"{w}x{h}", "--frames", str(MULTIHOST["frames"]),
                                "--out", str(out / "multihost.png")), {})
                             for r in range(2)],
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> [(returncode, output)] per process, every run started at
    once; a run whose rendezvous port another process took first is run
    again on new ports."""
    out = tmp_path_factory.mktemp("examples")
    base = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    results, todo = {}, None
    for _ in range(3):
        plan = _runs(out, free_port(), free_port())
        procs = {name: [subprocess.Popen(
            [sys.executable, *args], cwd=REPO, env=dict(base, **env),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for args, env in plan[name]] for name in (todo or plan)}
        try:
            for name, ps in procs.items():
                results[name] = [_wait(p) for p in ps]
        finally:
            for p in (p for ps in procs.values() for p in ps):
                if p.poll() is None:
                    p.kill()
        todo = [n for n, rs in results.items()
                if any(rc and "address already in use" in o.lower() for rc, o in rs)]
        if not todo:
            break
    results["out"] = out
    return results


def _wait(p):
    output = p.communicate(timeout=240)[0]
    return p.returncode, output


def _ok(runs, name):
    for rc, output in runs[name]:
        assert rc == 0, f"{name} failed:\n{output}"
    return runs[name][0][1]


@pytest.mark.parametrize("name", ["inverse_rendering", "inverse_rendering_2"])
def test_inverse_rendering(runs, name):
    """One process, and two ranks of one (2, 1) mesh (the sharded target
    and steps): the errors print and rank 0 writes both PNGs."""
    text = _ok(runs, name)
    assert re.search(r"max albedo error [0-9.]+  max emission error [0-9.]+", text)
    d = runs["out"] / ("inv" if name == "inverse_rendering" else "inv2")
    for png in ("inverse_target.png", "inverse_recovered.png"):
        img = read_png(str(d / png))
        assert img.shape == (16, 16, 3) and img.max() > 0


def test_geometry_recovery_moves_the_radius_toward_truth(runs):
    got = float(re.search(r"recovered radius ([0-9.]+)", _ok(runs, "geometry_recovery"))[1])
    assert 0.7 < got <= 1.3


def test_camera_pose_recovery_converges(runs):
    assert "camera pose recovered." in _ok(runs, "camera_pose_recovery")


def test_multihost_render_is_the_single_process_render(runs, tmp_path):
    """Two ranks, each its half of the pixel ids; rank 0's PNG is the
    single-process EMA render's bit for bit."""
    _ok(runs, "multihost_render")
    assert "wrote" in runs["multihost_render"][0][1]
    w, h = MULTIHOST["size"]
    cfg = FilmConfig(w, h)
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device="cpu")
    pixel, xs, ys = _pixel_grid(cfg, "cpu")
    acc = torch.zeros((cfg.num_pixels, 3))
    for f in range(MULTIHOST["frames"]):
        sample = render_pixels(scene, cam, RenderSettings(max_bounces=4), cfg, f,
                               pixel, xs, ys)
        acc = (acc * f + sample) / (f + 1)
    write_png(str(tmp_path / "want.png"), acc.numpy().reshape(h, w, 3))
    got = read_png(str(runs["out"] / "multihost.png"))
    assert np.array_equal(got, read_png(str(tmp_path / "want.png")))
