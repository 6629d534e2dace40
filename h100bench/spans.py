"""The program's own spans in the traced window: the ``rvpt.*`` ranges that
``rvpt_tpu_torch.utils.profiling.annotate`` records while a profiler runs,
read back from the trace that ``harness.profile`` writes
(``out/<workload>.trace.json``), beside the device's work and idle time.

* A span is kept when its start lies inside an ``h100bench.<unit>`` span
  (the harness's iteration), on any thread: the autograd engine runs a
  backward's launches on a thread of its own.
* Each device event (``trace.DEVICE_CATS``) of the window is tied to the
  host call that launched it (a ``cuda_runtime`` or ``cuda_driver`` event:
  ``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``,
  ``cudaMemsetAsync`` ...) by the trace's ``correlation`` id, and through
  it to the innermost kept span on that call's process and thread.
* Each idle gap of the device in the window goes to the innermost kept
  span, on the thread of the iteration spans, that holds its midpoint.

Per span name, per iteration: calls; host ms, total and self (its
duration less what the spans nested in it on its thread cover); device
ms and device ops tied to it; device idle ms charged to it.  The row
``(none)`` holds the device work and idle time tied to no span.

    python3 -m h100bench.spans h100bench/out/<workload>.trace.json --unit frame|step
"""

from __future__ import annotations

import argparse
import bisect
import functools
import json
import sys
from collections import defaultdict
from pathlib import Path

from .trace import DEVICE_CATS, SPAN, merged, union_us

PREFIX = "rvpt."
NONE = "(none)"
HOST_CATS = ("cuda_runtime", "cuda_driver")
TRACES = Path(__file__).resolve().parent / "out"


def _thread(e) -> tuple:
    return (e.get("pid"), e.get("tid"))


def _correlation(e):
    return (e.get("args") or {}).get("correlation")


class _Thread:
    """The kept spans of one thread, by start: (start, end, index)."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]

    def innermost(self, t: float):
        """Index of the latest-starting span that holds ``t``, or None."""
        for s, e, i in reversed(self.spans[:bisect.bisect_right(self.starts, t)]):
            if e >= t:
                return i
        return None


class Spans:
    """The ``rvpt.*`` spans of one traced window, reduced per name."""

    def __init__(self, events: list, unit: str):
        xs = [e for e in events if e.get("ph") == "X"]
        iters = sorted((e for e in xs if e.get("cat") == "user_annotation"
                        and e.get("name") == SPAN + unit), key=lambda e: e["ts"])
        if not iters:
            raise RuntimeError(f"the trace holds no {SPAN + unit} span")
        self.iterations = len(iters)
        bounds = [(e["ts"], e["ts"] + e["dur"]) for e in iters]
        starts = [s for s, _ in bounds]

        def in_iteration(t):
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t <= bounds[i][1]

        self.spans = [(e["name"], e["ts"], e["ts"] + e["dur"], _thread(e))
                      for e in xs if e.get("cat") == "user_annotation"
                      and e.get("name", "").startswith(PREFIX) and in_iteration(e["ts"])]
        by_thread = defaultdict(list)
        for i, (_, s, e, th) in enumerate(self.spans):
            by_thread[th].append((s, e, i))
        threads = {th: _Thread(v) for th, v in by_thread.items()}

        w0 = bounds[0][0]
        dev = [e for e in xs if e.get("cat") in DEVICE_CATS and e["ts"] >= w0]
        w1 = max([bounds[-1][1]] + [e["ts"] + e["dur"] for e in dev])
        self.window_us = w1 - w0
        self.iteration_us = sum(e - s for s, e in bounds)
        launch = {}
        for e in xs:
            if e.get("cat") in HOST_CATS and _correlation(e) is not None:
                launch[_correlation(e)] = (_thread(e), e["ts"])

        n = len(self.spans)
        self.dev_us, self.dev_ops, self.idle_us = [0.0] * (n + 1), [0] * (n + 1), [0.0] * (n + 1)
        # (device event's name, the span it is tied to or NONE)
        self.tied = []
        for e in dev:
            i = None
            if _correlation(e) in launch:
                th, t = launch[_correlation(e)]
                i = threads[th].innermost(t) if th in threads else None
            k = n if i is None else i
            self.dev_us[k] += e["dur"]
            self.dev_ops[k] += 1
            self.tied.append((e["name"], NONE if i is None else self.spans[i][0]))
        busy = merged([(e["ts"], e["ts"] + e["dur"]) for e in dev])
        main = threads.get(_thread(iters[0]))
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        for s, e in zip(edges[::2], edges[1::2]):
            if e > s:
                i = main.innermost(0.5 * (s + e)) if main else None
                self.idle_us[n if i is None else i] += e - s
        self.busy_us = union_us(busy)

        self.self_us = []
        for i, (_, s, e, th) in enumerate(self.spans):
            inner = [(a, b) for a, b, j in threads[th].spans if j != i and a >= s and b <= e]
            self.self_us.append((e - s) - union_us(inner))

    def names(self) -> list:
        """The span names, by first start."""
        first = {}
        for name, s, _, _ in self.spans:
            first[name] = min(s, first.get(name, s))
        return sorted(first, key=first.get)

    def _per_iteration(self, values, names):
        """The sum of ``values`` over the spans named ``names``, per
        iteration; None when the window holds no such span."""
        idx = [i for i, sp in enumerate(self.spans) if sp[0] in names]
        if not idx:
            return None
        return sum(values[i] for i in idx) / self.iterations

    def _ms(self, values_us, names):
        v = self._per_iteration(values_us, names)
        return None if v is None else v / 1e3

    def calls(self, name: str) -> float:
        return sum(sp[0] == name for sp in self.spans) / self.iterations

    def host_ms(self, *names) -> float | None:
        return self._ms([e - s for _, s, e, _ in self.spans], names)

    def self_ms(self, *names) -> float | None:
        return self._ms(self.self_us, names)

    def device_ms(self, *names) -> float | None:
        return self._ms(self.dev_us, names)

    def device_ops(self, *names) -> float | None:
        return self._per_iteration(self.dev_ops, names)

    def idle_ms(self, *names) -> float | None:
        return self._ms(self.idle_us, names)

    def table(self) -> list:
        """One row per span name, then ``(none)``: name, calls, host ms,
        self ms, device ms, device ops and idle ms, each per iteration."""
        rows = [[nm, self.calls(nm), self.host_ms(nm), self.self_ms(nm),
                 self.device_ms(nm), self.device_ops(nm), self.idle_ms(nm)]
                for nm in self.names()]
        k = self.iterations
        rows.append([NONE, 0.0, 0.0, 0.0, self.dev_us[-1] / k / 1e3,
                     self.dev_ops[-1] / k, self.idle_us[-1] / k / 1e3])
        return rows

    @classmethod
    def load(cls, path, unit: str) -> "Spans":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"], unit)


@functools.lru_cache(maxsize=1)
def _cached(path: str, unit: str, stamp: tuple) -> Spans:
    return Spans.load(path, unit)


def for_run(run, unit: str) -> Spans | None:
    """The spans of ``run``'s traced window (its trace file, read once for
    all the readers), or None for an untraced run or another unit."""
    if run.trace is None or run.unit != unit:
        return None
    path = TRACES / f"{run.workload}.trace.json"
    st = path.stat()
    return _cached(str(path), unit, (st.st_mtime_ns, st.st_size))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="The program's spans of a traced window.")
    p.add_argument("trace")
    p.add_argument("--unit", choices=("frame", "step"), required=True)
    a = p.parse_args(argv)
    s = Spans.load(a.trace, a.unit)
    k = s.iterations
    print(f"{k} {a.unit}s; per {a.unit}: window {s.window_us / k / 1e3:.4f} ms, "
          f"{SPAN}{a.unit} spans {s.iteration_us / k / 1e3:.4f} ms, "
          f"device busy {s.busy_us / k / 1e3:.4f} ms")
    print(f"{'span':<28} {'calls':>6} {'host_ms':>9} {'self_ms':>9} "
          f"{'device_ms':>9} {'dev_ops':>8} {'idle_ms':>9}")
    for nm, c, h, sf, d, o, i in s.table():
        print(f"{nm:<28} {c:>6.2f} {h:>9.4f} {sf:>9.4f} {d:>9.4f} {o:>8.2f} {i:>9.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
