"""The benchmark's arithmetic on the CPU: the traced window's reduction on
synthetic events, the roofline bounds against chip_smoke.py's printed
Cornell numbers, and the traffic's determinism in the seed."""

import json
from pathlib import Path

import pytest
import torch

from h100bench import bounds
from h100bench.reference import kajiya as ref
from h100bench.scenes import cornell_box, mesh_demo
from h100bench.trace import Trace, matcher, merged, union_us

HERE = Path(__file__).resolve().parents[1]


def ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_union_and_merge():
    iv = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert union_us(iv) == 12 + 10 + 1
    assert merged(iv) == [[0, 12], [20, 30], [40, 41]]
    assert union_us([]) == 0


def test_trace_window_idle_and_gaps():
    events = [
        ev("h100bench.frame", 100, 50, "user_annotation"),
        ev("h100bench.frame", 160, 40, "user_annotation"),
        ev("void (anonymous namespace)::path_kernel<0, 0, false, false>(float const*)", 110, 30),
        ev("void at::native::vectorized_elementwise_kernel<4>", 145, 10),
        ev("Memcpy HtoD (Pageable -> Device)", 150, 2, "gpu_memcpy"),
        ev("void (anonymous namespace)::path_kernel<0, 0, false, false>(float const*)", 170, 40),
        ev("early kernel before the window", 10, 5),
        ev("aten::mul", 101, 5, "cpu_op"),
        ev("cudaLaunchKernel", 161, 8, "cuda_runtime"),
    ]
    t = Trace(events, "frame")
    assert t.iterations == 2
    assert t.window_us == 210 - 100
    assert t.busy_us == 30 + 10 + 40
    assert t.idle_share() == pytest.approx(1 - 80 / 110)
    k1 = matcher(("path_kernel",))
    assert t.device_us(k1) == 70 and t.count() == 4 and t.count(k1) == 2
    assert not matcher(("gather_kernel",))("_scatter_gather_elementwise_kernel")
    gaps = dict(t.idle_gaps())
    assert sum(gaps.values()) == pytest.approx((110 - 100 + 145 - 140 + 170 - 155) / 1e6)
    assert gaps["h100bench.frame"] == pytest.approx(5 / 1e6)
    assert gaps["h100bench.frame > aten::mul"] == pytest.approx(10 / 1e6)
    assert gaps["h100bench.frame > cudaLaunchKernel"] == pytest.approx(15 / 1e6)
    assert t.top_ops()[0][1] == pytest.approx(70 / 1e6)


def test_trace_without_a_window_raises():
    with pytest.raises(RuntimeError):
        Trace([ev("x", 0, 1)], "step")


def test_k1_bound_is_chip_smokes():
    """chip_smoke.py's Cornell numbers (PERF.md, PR 11): the row census of
    the 1080p frame 1 at 4 bounces (2,073,600 camera searches, then
    640,895 / 491,375 / 413,087) and K1's closest-hit bound 0.0454 ms by
    operations.  The reference's census of the same inputs gives both."""
    s = cornell_box.build({}, "cpu")
    w, h = 1920, 1080
    cam = ref.camera_vector(s, w, h)
    pix = torch.arange(w * h)
    tab = ref.Tables(s)
    census = {}
    with torch.no_grad():
        for i in range(0, w * h, ref.RAY_CHUNK):
            p = pix[i:i + ref.RAY_CHUNK]
            ref.trace(s, tab, ref.kernel_rays(cam, p, 1), p, 1, 16, 4, "standard",
                      census=census)
    per_bounce = [sum(census["search"][b::4]) for b in range(4)]
    assert per_bounce == [2073600, 640895, 491375, 413087]
    total = {k: sum(v) for k, v in census.items()} | {"rays": w * h, "bounces": 4}
    assert round(bounds.k1_bound_s(total, (12, 2, 0)) * 1e3, 4) == 0.0454
    # K2 on that record: bytes bound it, 48 B per live slot, 4 per dead one
    # and 44 per ray.
    live = sum(per_bounce)
    want = (live * 48 + (w * h * 4 - live) * 4 + w * h * 44) / bounds.PEAK_BYTES
    assert bounds.k2_bound_s(total) == pytest.approx(want)


@pytest.mark.parametrize("traffic", ["display-kajiya", "train-albedo-emission",
                                     "train-albedo-emission-vertices"])
def test_traffic_is_the_seeds(traffic):
    """The same seed gives the same inputs; another seed, others."""
    t = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    mod = __import__(f"h100bench.loops.{t['loop']}", fromlist=["Loop"])
    maker = mesh_demo if "vertices" in traffic else cornell_box
    cfg = json.loads((HERE / "configs" / ("mesh5-1080p.json" if maker is mesh_demo
                                          else "cornell-1080p.json")).read_text())

    def inputs(seed):
        loop = mod.Loop(cfg, t, seed, "cpu", maker.build)
        s = getattr(loop, "init", loop.scene)
        return ([getattr(s, k) for k in ("albedo", "emission", "v0", "v1", "v2")],
                sorted(getattr(loop, "plan", [])))

    a, b, c = inputs(2**31 + 12345), inputs(2**31 + 12345), inputs(7)
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0])) and a[1] == b[1]
    assert not all(torch.equal(x, y) for x, y in zip(a[0], c[0]))
