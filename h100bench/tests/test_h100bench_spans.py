"""The reduction of the program's spans (``h100bench/spans.py``) and the
seven readers of its metrics, on hand-written Chrome traces: two threads,
nested spans, launches tied to device events by correlation id, a memcpy
and a memset, a span and a kernel before the window."""

import json
from types import SimpleNamespace

import pytest

from h100bench import spans
from h100bench.harness import load_reader

MAIN, AUTOGRAD = 11, 12


def span(name, ts, end, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": end - ts, "pid": 1, "tid": tid}


def launch(corr, ts, tid=MAIN, name="cudaLaunchKernel", cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": 1, "pid": 1,
            "tid": tid, "args": {"correlation": corr}}


def device(corr, ts, dur, name="void k<0>()", cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0,
            "tid": 7, "args": {"correlation": corr}}


def frame_events():
    """Two frames, [100, 200] and [300, 400]: the sample (camera rays
    nested in it), the EMA (a memcpy, a memset and kernels) and the wait;
    a launcher span on a second thread; a kernel launched between the
    frames; a span and a kernel before the window."""
    return [
        span("h100bench.frame", 100, 200), span("h100bench.frame", 300, 400),
        span("rvpt.frame.ema", 10, 20), device(0, 50, 5),
        span("rvpt.frame.sample", 105, 150), span("rvpt.rays", 110, 120),
        span("rvpt.frame.ema", 150, 160), span("rvpt.frame.wait", 160, 195),
        span("rvpt.launch_x", 120, 185, tid=AUTOGRAD),
        launch(1, 112), device(1, 130, 5),
        launch(2, 140), device(2, 140, 30, "path_kernel"),
        launch(3, 152, name="cudaMemcpyAsync"), device(3, 171, 2, "Memcpy HtoD", "gpu_memcpy"),
        launch(4, 155), device(4, 173, 4),
        launch(5, 125, AUTOGRAD, "cuLaunchKernel", "cuda_driver"), device(5, 180, 3),
        launch(10, 250), device(10, 260, 2),
        span("rvpt.frame.sample", 305, 350), span("rvpt.rays", 310, 318),
        span("rvpt.frame.ema", 350, 362), span("rvpt.frame.wait", 362, 398),
        launch(6, 312), device(6, 320, 6),
        launch(7, 340), device(7, 330, 40, "path_kernel"),
        launch(8, 355, name="cudaMemsetAsync"), device(8, 371, 1, "Memset", "gpu_memset"),
        launch(9, 356), device(9, 372, 5),
    ]


def step_events():
    """Two steps, [1000, 2000] and [2100, 3000], each in its six phases,
    a pack nested in each render, K2's launcher on the autograd thread."""
    return [
        span("h100bench.step", 1000, 2000), span("h100bench.step", 2100, 3000),
        span("rvpt.step.load", 1001, 1010), span("rvpt.step.render_a", 1010, 1300),
        span("rvpt.pack", 1020, 1050), span("rvpt.step.render_b", 1300, 1600),
        span("rvpt.pack", 1310, 1330), span("rvpt.step.backward", 1600, 1800),
        span("rvpt.launch_bwd_kernel", 1650, 1700, tid=AUTOGRAD),
        launch(1, 1660, AUTOGRAD), device(1, 1700, 50, "bwd_kernel"),
        span("rvpt.step.adam", 1800, 1900), span("rvpt.step.constrain", 1900, 1950),
        span("rvpt.step.load", 2101, 2105), span("rvpt.step.render_a", 2105, 2400),
        span("rvpt.pack", 2110, 2150), span("rvpt.step.render_b", 2400, 2700),
        span("rvpt.pack", 2410, 2420), span("rvpt.step.backward", 2700, 2850),
        span("rvpt.step.adam", 2850, 2950), span("rvpt.step.constrain", 2950, 2990),
    ]


def test_frame_reduction():
    s = spans.Spans(frame_events(), "frame")
    assert s.iterations == 2 and s.window_us == 300
    assert s.names() == ["rvpt.frame.sample", "rvpt.rays", "rvpt.launch_x",
                         "rvpt.frame.ema", "rvpt.frame.wait"]
    assert s.calls("rvpt.rays") == 1 and s.calls("rvpt.launch_x") == 0.5
    assert s.host_ms("rvpt.frame.sample") == pytest.approx(0.045)
    assert s.self_ms("rvpt.frame.sample") == pytest.approx((35 + 37) / 2e3)
    assert s.device_ms("rvpt.rays") == pytest.approx(11 / 2e3)
    assert s.device_ms("rvpt.frame.sample") == pytest.approx(70 / 2e3)
    assert s.device_ops("rvpt.frame.ema") == 2
    assert s.device_ms("rvpt.launch_x") == pytest.approx(3 / 2e3)
    # Idle gaps go by their midpoint to the main thread's innermost span:
    # [100, 130] to the rays, [177, 180] to the wait, not to rvpt.launch_x.
    assert s.idle_ms("rvpt.rays") == pytest.approx(30 / 2e3)
    assert s.idle_ms("rvpt.frame.sample") == pytest.approx(9 / 2e3)
    assert s.idle_ms("rvpt.frame.wait") == pytest.approx(28 / 2e3)
    assert s.idle_ms("rvpt.launch_x") == 0
    rows = {r[0]: r for r in s.table()}
    assert rows[spans.NONE][4:] == pytest.approx([2 / 2e3, 0.5, 135 / 2e3])
    idle = sum(r[6] for r in rows.values())
    assert (idle + s.busy_us / 2e3) * 2e3 == pytest.approx(s.window_us)
    assert ("path_kernel", "rvpt.frame.sample") in s.tied
    assert s.host_ms("rvpt.step.adam") is None


def test_step_reduction_and_the_table(capsys, tmp_path):
    s = spans.Spans(step_events(), "step")
    assert s.calls("rvpt.pack") == 2
    assert s.self_ms("rvpt.step.render_a") == pytest.approx((260 + 255) / 2e3)
    assert s.tied == [("bwd_kernel", "rvpt.launch_bwd_kernel")]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": step_events()}))
    assert spans.main([str(path), "--unit", "step"]) == 0
    out = capsys.readouterr().out
    assert "rvpt.launch_bwd_kernel" in out and spans.NONE in out


READINGS = {
    "rays_ms.frame": ("frame", 11 / 2e3),
    "ema_ms.frame": ("frame", 12 / 2e3),
    "wait_ms.frame": ("frame", (35 + 36) / 2e3),
    "render_ms.step": ("step", (590 + 595) / 2e3),
    "backward_ms.step": ("step", (200 + 150) / 2e3),
    "adam_ms.step": ("step", 100 / 1e3),
    "pack_ms.step": ("step", (30 + 20 + 40 + 10) / 2e3),
}


def _run(tmp_path, monkeypatch, unit, events, traced=True):
    monkeypatch.setattr(spans, "TRACES", tmp_path)
    (tmp_path / f"cell-{unit}.trace.json").write_text(json.dumps({"traceEvents": events}))
    return SimpleNamespace(trace=object() if traced else None, unit=unit,
                           workload=f"cell-{unit}")


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_each_reader(metric, tmp_path, monkeypatch):
    unit, want = READINGS[metric]
    events = frame_events() if unit == "frame" else step_events()
    read = load_reader(metric)
    assert read(_run(tmp_path, monkeypatch, unit, events)) == pytest.approx(want)
    # Nothing to read: no rvpt span, an untraced run, the other unit.
    bare = [e for e in events if not e["name"].startswith(spans.PREFIX)]
    assert read(_run(tmp_path, monkeypatch, unit, bare)) is None
    assert read(_run(tmp_path, monkeypatch, unit, events, traced=False)) is None
    other = "step" if unit == "frame" else "frame"
    assert read(_run(tmp_path, monkeypatch, other, events)) is None
