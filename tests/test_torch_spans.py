"""The port's spans (``utils.profiling.annotate``): a shared no-op while no
profiler records, and ``rvpt.*`` ranges at the layer boundaries while one
does: ``Renderer.draw``'s sample, EMA and wait, the trainer step's six
phases and the tables packed, one per bounce of the SoA replay; on the
card, the launchers' spans, on the autograd engine's thread too.  This
file imports no JAX, so its card test runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_spans.py
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from rvpt_tpu_torch import FilmConfig, RenderSettings
from rvpt_tpu_torch.ops import replay_soa
from rvpt_tpu_torch.renderer import Renderer
from rvpt_tpu_torch.scene import builtin
from rvpt_tpu_torch.train import inverse
from rvpt_tpu_torch.utils import profiling

STEP = ["rvpt.step.load", "rvpt.step.render_a", "rvpt.step.render_b",
        "rvpt.step.backward", "rvpt.step.adam", "rvpt.step.constrain"]


def _spans(prof):
    """The ``rvpt.*`` events of a profile, by start."""
    evs = [e for e in prof.events() if e.name.startswith(profiling.SPAN)]
    return [e.name for e in sorted(evs, key=lambda e: e.time_range.start)]


def _trainer(device, size=8):
    cfg = FilmConfig(width=size, height=size)
    st = RenderSettings(max_bounces=2, style="standard")
    scene, cam = builtin.cornell_box(aspect=1.0, device=device)
    target = torch.zeros((3, size, size), device=device)
    step, opt = inverse.make_train_step(scene, cam, st, cfg, None, target)
    return step, opt, inverse.trainable_params(scene)


def test_no_span_without_a_profiler():
    off = profiling.annotate("frame.sample")
    assert off is profiling.annotate("step.adam")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with off:
            torch.ones(4).sum()
        with profiling.annotate("frame.ema"):
            torch.ones(4).sum()
    assert _spans(prof) == ["rvpt.frame.ema"]


def test_draw_records_sample_ema_and_wait():
    cfg = FilmConfig(width=16, height=12)
    scene, cam = builtin.cornell_box(aspect=cfg.aspect, device="cpu")
    r = Renderer(scene, cam, RenderSettings(max_bounces=2), cfg)
    r.draw()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.draw()
    assert _spans(prof) == ["rvpt.frame.sample", "rvpt.frame.ema", "rvpt.frame.wait"]


def test_train_step_records_its_phases_in_order():
    step, opt, params = _trainer("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, opt, 0)
    names = _spans(prof)
    assert [n for n in names if n.startswith("rvpt.step.")] == STEP
    # Each render makes its camera rays and builds a tracer, packing the tables.
    assert names.count("rvpt.rays") == 2 and names.count("rvpt.pack") == 2
    a, b, back = (names.index(s) for s in STEP[1:4])
    pack_a, pack_b = (i for i, nm in enumerate(names) if nm == "rvpt.pack")
    assert a < pack_a < b < pack_b < back


def test_replay_records_one_span_per_bounce():
    scene, _ = builtin.cornell_box(device="cpu")
    n, bounces = 6, 3
    g = torch.Generator().manual_seed(5)
    origin = torch.randn((n, 3), generator=g)
    direction = torch.randn((n, 3), generator=g)
    fams = torch.randint(-1, 2, (bounces, n), generator=g, dtype=torch.int32)
    idxs = torch.randint(0, 2, (bounces, n), generator=g, dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = replay_soa.kajiya_replay_soa(scene, origin, direction,
                                           torch.arange(n), 1, 16, fams, idxs)
    assert out.shape == (n, 3) and bool(torch.isfinite(out).all())
    assert _spans(prof) == ["rvpt.replay.bounce"] * bounces


@pytest.mark.cuda
def test_k2_is_tied_to_its_launcher_on_the_backward_thread(tmp_path):
    """A traced card step: K2's launcher span, opened on the autograd
    engine's thread, holds the launches of ``bwd_kernel`` and
    ``table_sum_kernel`` (tied by the trace's correlation ids)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from h100bench.spans import Spans

    step, opt, params = _trainer("cuda", size=64)
    step(params, opt, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("h100bench.step"):
            step(params, opt, 1)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    s = Spans(events, "step")
    threads = {th for nm, _, _, th in s.spans if nm == "rvpt.launch_bwd_kernel"}
    step_threads = {th for nm, _, _, th in s.spans if nm == "rvpt.step.backward"}
    assert len(threads) == 1 and threads != step_threads
    tied = {nm for nm, span in s.tied if span == "rvpt.launch_bwd_kernel"}
    assert any("bwd_kernel" in k for k in tied) and any("table_sum_kernel" in k for k in tied)
    assert s.device_ops("rvpt.launch_bwd_kernel") == 2
