"""The traced window: torch.profiler over a few iterations of the loop, and
the reduction of its chrome trace to what the per-layer readers take.

The arithmetic is profile_slice.py's (:47-58, :207-270), frozen here:
device operations are the trace's events of the categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; the device is busy over the union of
their intervals; the traced window runs from the first iteration's span
to the later of the last span's end and the last device event's end; the
idle share is 1 - busy / window.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = "h100bench."


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def matcher(names):
    """A test of a device event's name: does it hold one of ``names`` as a
    whole identifier (``path_kernel`` in ``(anonymous namespace)::
    path_kernel<...>(...)``)?"""
    rx = re.compile(r"(?<![A-Za-z0-9_])(?:%s)(?![A-Za-z0-9_])" % "|".join(names))
    return lambda name: rx.search(name) is not None


class Trace:
    """One traced window: ``iterations`` spans named ``h100bench.<unit>``,
    the device events inside the window, and the host's events."""

    def __init__(self, events: list, unit: str):
        spans = sorted((e for e in events if e.get("ph") == "X"
                        and e.get("cat") == "user_annotation"
                        and e.get("name") == SPAN + unit), key=lambda e: e["ts"])
        if not spans:
            raise RuntimeError(f"the trace holds no {SPAN + unit} span")
        w0 = spans[0]["ts"]
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
               and e["ts"] >= w0]
        if not dev:
            raise RuntimeError("the trace holds no device operation in its window")
        w1 = max(spans[-1]["ts"] + spans[-1]["dur"],
                 max(e["ts"] + e["dur"] for e in dev))
        self.iterations = len(spans)
        self.window_us = w1 - w0
        self.device = [(e["name"], e["ts"], e["dur"]) for e in dev]
        self.busy_us = union_us([(ts, ts + d) for _, ts, d in self.device])
        self.spans = [(e["ts"], e["ts"] + e["dur"]) for e in spans]
        self.host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                            for e in events if e.get("ph") == "X"
                            and e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver")
                            and w0 <= e["ts"] <= w1), key=lambda h: h[0])
        self.w0, self.w1 = w0, w1
        self.unit = unit

    @classmethod
    def load(cls, path: Path, unit: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"], unit)

    def device_us(self, match=None) -> float:
        """Device time of the events whose name ``match`` accepts (all)."""
        return sum(d for n, _, d in self.device if match is None or match(n))

    def count(self, match=None) -> int:
        return sum(1 for n, _, _ in self.device if match is None or match(n))

    def idle_share(self) -> float:
        return 1.0 - self.busy_us / self.window_us

    def top_ops(self, k: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        by = defaultdict(float)
        for n, _, d in self.device:
            by[n[:120]] += d
        return [[n, us / 1e6] for n, us in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def _host_at(self, t: float) -> str:
        """What the host was in at time ``t``: the iteration's span, if
        any, and the innermost host event around ``t`` (the latest to start
        among those still running)."""
        i = bisect.bisect_right(self.spans, (t, float("inf")))
        in_span = i > 0 and self.spans[i - 1][1] >= t
        inner = None
        j = bisect.bisect_right(self.host, (t, float("inf"), ""))
        for s, e, name in reversed(self.host[max(0, j - 4000):j]):
            if e >= t:
                inner = name
                break
        where = SPAN + self.unit if in_span else "between iterations"
        return where + (f" > {inner}" if inner else "")

    def idle_gaps(self, k: int = 10) -> list:
        """[what the host was doing, seconds] of the device's idle time in
        the window, summed by that name, longest first."""
        by = defaultdict(float)
        busy = merged([(ts, ts + d) for _, ts, d in self.device])
        edges = [self.w0] + [x for iv in busy for x in iv] + [self.w1]
        for s, e in zip(edges[::2], edges[1::2]):
            if e > s:
                by[self._host_at(0.5 * (s + e))[:120]] += e - s
        return [[n, us / 1e6] for n, us in sorted(by.items(), key=lambda x: -x[1])[:k]]
