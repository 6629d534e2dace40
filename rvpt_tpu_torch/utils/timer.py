"""Frame timing with a rolling window.

Re-design of the reference's ``Timer`` (src/rvpt/timer.h:12-35,
timer.cpp:9-46): wall-clock per-frame timing, 50-frame rolling average,
fastest/slowest tracking, plus ray-throughput derivation (the metric the
reference never computed but implied via its FPS counter, rvpt.cpp:264-269).
"""

from __future__ import annotations

import time
from collections import deque


class FrameTimer:
    WINDOW = 50  # reference: timer.cpp:25-26

    def __init__(self) -> None:
        self._window: deque[float] = deque(maxlen=self.WINDOW)
        self._start: float | None = None
        self._last_frame_end: float | None = None
        self.fastest = float("inf")
        self.slowest = 0.0
        self.frames = 0

    def frame_start(self) -> None:
        self._start = time.perf_counter()

    def frame_stop(self) -> float:
        assert self._start is not None, "frame_stop without frame_start"
        dt = time.perf_counter() - self._start
        self._window.append(dt)
        self.fastest = min(self.fastest, dt)
        self.slowest = max(self.slowest, dt)
        self.frames += 1
        self._last_frame_end = time.perf_counter()
        return dt

    def since_last_frame(self) -> float:
        """Input dt for camera movement (reference: timer.h:21, main.cpp:67)."""
        if self._last_frame_end is None:
            return 0.0
        return time.perf_counter() - self._last_frame_end

    @property
    def average(self) -> float:
        return sum(self._window) / len(self._window) if self._window else 0.0

    @property
    def fps(self) -> float:
        avg = self.average
        return 1.0 / avg if avg > 0 else 0.0

    def rays_per_second(self, rays_per_frame: int) -> float:
        avg = self.average
        return rays_per_frame / avg if avg > 0 else 0.0

    def stats(self, rays_per_frame: int = 0) -> dict:
        out = {
            "frames": self.frames,
            "avg_ms": self.average * 1e3,
            "fps": self.fps,
            "fastest_ms": self.fastest * 1e3 if self.frames else 0.0,
            "slowest_ms": self.slowest * 1e3,
        }
        if rays_per_frame:
            out["mrays_per_s"] = self.rays_per_second(rays_per_frame) / 1e6
        return out
