"""Structured metrics: a JSONL logger, a rays/s meter and a profiler capture."""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Iterator

import torch


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


@contextlib.contextmanager
def profile_trace(logdir: str | Path | None) -> Iterator[None]:
    """``torch.profiler`` capture around a region, written as a Chrome trace
    ``trace.json`` into ``logdir`` (view in Perfetto or chrome://tracing);
    CUDA activity is recorded when a card is present.  The counterpart of
    the JAX package's ``jax.profiler`` capture.  No-op when ``logdir`` is
    None, so call sites can leave it wired in."""
    if logdir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
