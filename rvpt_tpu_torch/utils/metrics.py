"""Structured metrics & logging (a copy of ``rvpt_tpu/utils/metrics.py``).

The reference logs unstructured fmt::print lines and shows live stats in
ImGui (SURVEY.md §5).  Here: a lightweight metrics registry that renderer /
training loops feed per-step dicts into, with rolling aggregation, JSONL
export, and stdout summaries — greppable and plottable.
"""

from __future__ import annotations

import json
import logging
import time
from collections import defaultdict, deque

logger = logging.getLogger("rvpt_tpu_torch")


def setup_logging(level: str = "INFO") -> None:
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(h)
    logger.setLevel(getattr(logging, level.upper()))


class Metrics:
    """Rolling per-key aggregation + optional JSONL sink."""

    def __init__(self, window: int = 50, jsonl_path: str | None = None):
        self._window = window
        self._series: dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window)
        )
        self._count = 0
        self._file = open(jsonl_path, "a") if jsonl_path else None

    def log(self, **values) -> None:
        self._count += 1
        for k, v in values.items():
            self._series[k].append(float(v))
        if self._file:
            rec = {"step": self._count, "ts": time.time(), **{
                k: float(v) for k, v in values.items()
            }}
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()

    def mean(self, key: str) -> float:
        s = self._series.get(key)
        return sum(s) / len(s) if s else float("nan")

    def last(self, key: str) -> float:
        s = self._series.get(key)
        return s[-1] if s else float("nan")

    def summary(self) -> dict:
        return {k: self.mean(k) for k in self._series}

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
