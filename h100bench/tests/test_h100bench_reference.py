"""The reference against the port's plain versions at a small film on the
CPU (only this file and the checks' tests import the port): the display
sample and the trainer's first steps, bit for bit or to rounding."""

import json
from pathlib import Path

import pytest
import torch

from h100bench import program
from h100bench.loops import display, train
from h100bench.reference import train as ref_train
from h100bench.scenes import cornell_box, mesh_demo

HERE = Path(__file__).resolve().parents[1]
W, H = 40, 24


def config(name):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    return dict(cfg, film=[W, H], check_rows=1.0)


@pytest.mark.parametrize("name,maker", [("cornell-1080p", cornell_box),
                                        ("mesh5-1080p", mesh_demo)])
def test_sample_is_the_ports(name, maker):
    """The reference's sample of a frame equals the port's display sample
    (``render_sample_fast_chw``, its kernels' plain versions here)."""
    from rvpt_tpu_torch.render import render_sample_fast_chw

    cfg = config(name)
    loop = display.Loop(cfg, {"integrator": 9}, 3, "cpu", maker.build)
    s = loop.scene
    ps, cam = program.port_scene(s), program.port_camera(s, W, H)
    st = program.settings(cfg["bounces"], cfg["style"])
    for frame in (0, 9):
        got = render_sample_fast_chw(ps, cam, st, program.film(W, H), frame)
        want = loop.sample(frame, torch.arange(W * H))
        assert torch.equal(got.reshape(3, -1), want)


def test_trainer_steps_are_the_ports():
    """The reference's first steps give the port's losses, first gradient
    and change to rounding."""
    cfg = config("cornell-1080p")
    traffic = json.loads((HERE / "traffic" / "train-albedo-emission.json").read_text())
    loop = train.Loop(cfg, traffic, 5, "cpu", cornell_box.build)
    loop.setup()
    got = {"losses": loop.losses, "grad1": ref_train.by_leaf(loop.grad1),
           "delta": ref_train.by_leaf({n: loop.after[n] - loop.before[n]
                                       for n in loop.names})}
    want = ref_train.follow(loop.true, loop.init, cfg, traffic, (W, H), train.TARGET_FRAME)
    gaps = ref_train.compare(got, want)
    assert all(v < 1e-5 for v in gaps.values()), gaps


def test_compare_by_worst_leaf():
    want = {"losses": [1.0, 2.0], "grad1": {"a": 1.0, "b": 2.0, "c": 1e-9},
            "delta": {"a": 0.1, "b": 0.2, "c": 0.3}}
    got = {"losses": [1.0, 2.2], "grad1": {"a": 1.0, "b": 2.3, "c": 5.0},
           "delta": {"a": 0.1, "b": 0.2, "c": 9.0}}
    gaps = ref_train.compare(got, want)
    # Leaf c's reference gradient is nought to rounding: it is left out.
    assert gaps == pytest.approx({"loss_gap": 0.1, "grad_gap": 0.3 / 2.0,
                                  "delta_gap": 0.0})
