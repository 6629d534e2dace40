"""Multi-process rvpt_tpu_torch over ``torch.distributed`` (mirror of
tests/test_distributed.py): ranks joined through ``initialize_distributed``
(a ``tcp://`` rendezvous, gloo on the CPU), each in its own OS process.

One 2-process job (``parallel.dryrun.parity_job``, a module fixture):
every rank's id through ``all_gather``; each rank renders its contiguous
half of the film's pixel ids and ``gather_film_to_host`` assembles it on
rank 0 (None elsewhere), which must be the single-process render in this
process bit for bit (tests/test_distributed.py:199); a sharded train step
over the two processes, fast and plain, against the single-process step
(tests/test_distributed.py:149; here bit for bit equal on both ranks and
within rtol 1e-5 of it); the collectives' times (``collectives_ms``).
Then ``dryrun_multichip(4)``, the port's
counterpart of ``__graft_entry__.dryrun_multichip``.
"""

import numpy as np
import pytest
import torch

from rvpt_tpu_torch import FilmConfig, RenderSettings
from rvpt_tpu_torch.parallel import distributed, dryrun
from rvpt_tpu_torch.render import _pixel_grid, render_pixels
from rvpt_tpu_torch.scene import builtin

FILM = (32, 16)
CASES = [("gather", (2, 1), FILM), ("train_fast_cornell", (2, 1), FILM),
         ("train_plain_cornell", (2, 1), FILM), ("collectives", (2, 1), FILM)]


def _key(name):
    return f"{name}@2x1@{FILM[0]}x{FILM[1]}"


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("distributed")
    dryrun.spawn(dryrun.parity_job, 2, args=(str(out), CASES), timeout=300)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


def test_all_gather_sees_both_ranks(job):
    for r in range(2):
        assert job[r][_key("gather") + ".got.ranks"].tolist() == [0, 1]


def test_two_process_render_and_gather(job):
    """Rank 0 holds the assembled film; rank 1 got None."""
    assert _key("gather") + ".got.film" not in job[1]
    got = job[0][_key("gather") + ".got.film"]
    cfg = FilmConfig(*FILM)
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device="cpu")
    pixel, xs, ys = _pixel_grid(cfg, "cpu")
    want = render_pixels(scene, cam, RenderSettings(max_bounces=2, style="standard"),
                         cfg, 1, pixel, xs, ys).numpy()
    assert got.shape == want.shape == (cfg.num_pixels, 3)
    assert np.array_equal(got, want), f"max diff {np.abs(got - want).max()}"


@pytest.mark.parametrize("route", ["fast", "plain"])
def test_two_process_training_step(job, route):
    key = _key(f"train_{route}_cornell")
    for leaf in ("materials.albedo", "materials.emission"):
        got = job[0][f"{key}.got.{leaf}"]
        assert np.array_equal(got, job[1][f"{key}.got.{leaf}"]), leaf
        np.testing.assert_allclose(got, job[0][f"{key}.want.{leaf}"], rtol=1e-5,
                                   atol=0, err_msg=leaf)
    np.testing.assert_allclose(job[0][f"{key}.got.loss"], job[0][f"{key}.want.loss"],
                               rtol=1e-5)


def test_collectives_are_timed(job):
    """``collectives_ms`` on two ranks: a frame's combine and a step's
    gradient and loss sums, each a time on both ranks."""
    for r in range(2):
        for part in ("frame", "step"):
            ms = float(job[r][f"{_key('collectives')}.got.{part}_ms"])
            assert 0.0 < ms < 1e4, (r, part, ms)


def test_gather_film_to_host_without_a_group():
    """With no process group (one process) the film itself, as NumPy."""
    film = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert np.array_equal(distributed.gather_film_to_host(film), film.numpy())


def test_dryrun_multichip():
    """A (2, 2) mesh of 4 gloo processes: one sharded train step, one
    kernel-route Cornell frame, one split-screen frame and one big-mesh
    frame, each finite."""
    dryrun.dryrun_multichip(4)
