"""Structured metrics: a JSONL logger and a rays/s meter."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any


class MetricsLogger:
    """Append-only JSONL metrics writer.

    Each record carries a monotonic timestamp and arbitrary scalar fields:
    ``{"ts": ..., "event": "render", "render_s": ..., ...}``.
    """

    def __init__(self, path: str | Path | None):
        self._path = Path(path) if path else None
        self._t0 = time.perf_counter()
        if self._path:
            self._path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, event: str, **fields: Any) -> dict[str, Any]:
        record = {"ts": round(time.perf_counter() - self._t0, 6), "event": event, **fields}
        if self._path:
            with self._path.open("a") as f:
                f.write(json.dumps(record) + "\n")
        return record


def rays_per_second(n_rays: int, depth: int, seconds: float) -> dict[str, float]:
    """Primary rays and trace segments per second.

    Each depth level costs one primary + one shadow sweep, so
    ``segments = n_rays * depth * 2``.
    """
    return {
        "primary_rays_per_s": n_rays / seconds,
        "trace_segments_per_s": n_rays * depth * 2 / seconds,
    }
