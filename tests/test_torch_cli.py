"""``python -m rvpt_tpu_torch.cli`` against ``rvpt_tpu.cli`` on the same
arguments, on the CPU (``--device cpu``; the port's CLI refuses to run
without a card otherwise).

Films 24x16.  Bars: the written PNGs agree on >= 99.5% of subpixels within
one u8 step (tests/test_megakernel.py's 99.5% bar at PNG precision; Hart
quadrants count at their own 99% bar, so the split film at 99%); the BVH
debug overlay draws the same lines in the same colors as JAX's; a
checkpoint written by either CLI resumes in the port's with the frame
count continuing; bad arguments exit 2 as in JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rvpt_tpu.cli import main as _j_main
from rvpt_tpu_torch.cli import main
from rvpt_tpu_torch.utils.image import read_png

BASE = ["--size", "24x16", "--frames", "2"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def j_main(argv, fresh=False):
    """The JAX CLI; ``fresh`` runs it in its own process, as a user does.
    In one process the JAX Renderer's jitted frame step fails on the second
    BVH scene it meets ("Execution supplied 22 buffers but compiled program
    expected 30"), even after jax.clear_caches(), and another test file on
    the same worker may have drawn one already."""
    if not fresh:
        return _j_main(argv)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", "rvpt_tpu.cli", *argv], cwd=ROOT,
                          env=env, capture_output=True, timeout=600).returncode


def _png_share(a, b, steps=1):
    return (np.abs(read_png(a).astype(int) - read_png(b).astype(int)) <= steps).mean()


def _both(tmp_path, name, args, fresh=False):
    got, want = str(tmp_path / f"{name}_port.png"), str(tmp_path / f"{name}_jax.png")
    assert main(["--device", "cpu", *args, "--out", got]) == 0
    assert j_main([*args, "--out", want], fresh) == 0
    return got, want


@pytest.mark.parametrize("integ", ["kajiya", "whitted"])
def test_cli_matches_jax(tmp_path, integ):
    got, want = _both(tmp_path, integ, ["--scene", "cornell", "--integrator", integ,
                                        "--bounces", "3", *BASE])
    assert read_png(got).shape == (16, 24, 3)
    assert _png_share(got, want) >= 0.995


def test_cli_split_matches_jax(tmp_path):
    got, want = _both(tmp_path, "split", ["--scene", "cornell", "--split",
                                          "ao,whitted,hart,kajiya", "--bounces", "3",
                                          "--style", "standard", *BASE])
    assert _png_share(got, want) >= 0.99


def test_cli_bvh_debug_view_matches_jax(tmp_path):
    got, want = _both(tmp_path, "bvh", ["--scene", "cornell", "--bvh", "--debug-view",
                                        "bvh", "--bounces", "2", *BASE], fresh=True)
    assert _png_share(got, want) >= 0.995
    g_dbg, w_dbg = (read_png(p.replace(".png", "_bvh.png")).astype(int) for p in (got, want))
    g_lines = (g_dbg != read_png(got)).any(-1)
    w_lines = (w_dbg != read_png(want)).any(-1)
    assert g_lines.sum() > 20
    np.testing.assert_array_equal(g_lines, w_lines)
    np.testing.assert_array_equal(g_dbg[g_lines], w_dbg[w_lines])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cli_checkpoint_and_resume(tmp_path, writer, capsys):
    ck = str(tmp_path / "ck.npz")
    args = ["--scene", "rabbit", "--bounces", "2", *BASE, "--checkpoint", ck]
    if writer == "port":
        assert main(["--device", "cpu", *args, "--out", str(tmp_path / "a.png")]) == 0
    else:
        assert j_main([*args, "--out", str(tmp_path / "a.png")], fresh=True) == 0
    capsys.readouterr()
    ck2 = str(tmp_path / "ck2.npz")
    rc = main(["--device", "cpu", "--scene", "rabbit", "--bounces", "2", "--size", "24x16",
               "--frames", "3", "--resume", ck, "--checkpoint", ck2, "--stats",
               "--out", str(tmp_path / "b.png")])
    assert rc == 0
    err = capsys.readouterr().err
    assert "resumed at frame 2" in err and "'accumulated_frames': 5" in err
    with np.load(ck2) as data:
        assert int(data["['film']/.frame"]) == 5
        assert data["['film']/.accum"].shape == (3, 16, 24)


def test_cli_bad_args(monkeypatch):
    assert main(["--device", "cpu", "--scene", "nope"]) == 2
    assert main(["--device", "cpu", "--integrator", "nope"]) == 2
    assert main(["--device", "cpu", "--split", "a,b"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--size", "8x8", "--frames", "1"]) == 1
