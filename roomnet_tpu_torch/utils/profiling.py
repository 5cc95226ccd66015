"""Tracing and profiling (port of roomnet_tpu/utils/profiling.py).

  * `trace(name)`: a context manager that marks the span for the PyTorch
    profiler (`torch.profiler.record_function`, visible in a chrome trace)
    and adds its wall time to the process-wide registry `SPANS`;
  * `SPANS.count(name, value)`: accumulates a value (bytes shipped, ...);
  * `StepTimer`: steps/s and images/s with an exponential moving average;
  * `trace_to(log_dir)`: a `torch.profiler` capture, written as a chrome trace.

The JAX package's `start_server` (jax.profiler's gRPC capture server) has
no PyTorch counterpart and is not ported.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import torch
from torch.profiler import record_function


class _Registry:
    # Per-span ring of recent durations: enough for meaningful p50/p99
    # over a serving window, bounded so a long-lived daemon never grows.
    RING = 512

    def __init__(self):
        self._lock = threading.Lock()
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._recent: dict[str, list[float]] = defaultdict(list)
        # Plain accumulators (bytes shipped, rows padded, ...): values,
        # not durations, reported as {"total", "count"} in summary().
        self._counters: dict[str, float] = defaultdict(float)
        self._counter_events: dict[str, int] = defaultdict(int)

    def count(self, name: str, value: float):
        """Accumulate a measured value (not a duration) under `name`."""
        with self._lock:
            self._counters[name] += value
            self._counter_events[name] += 1

    def add(self, name: str, dt: float):
        with self._lock:
            self.totals[name] += dt
            self.counts[name] += 1
            ring = self._recent[name]
            if len(ring) >= self.RING:
                # counts already includes this sample, so the oldest one
                # sits at (counts - 1) % RING.
                ring[(self.counts[name] - 1) % self.RING] = dt
            else:
                ring.append(dt)

    def summary(self) -> dict[str, dict[str, float]]:
        """{span: {total_s, count, mean_ms, p50_ms, p99_ms}} and {counter:
        {total, count}}. Raises ValueError when a span and a counter share a
        name: one would silently replace the other in the result."""
        with self._lock:
            both = sorted(set(self.totals) & set(self._counters))
            if both:
                raise ValueError(f"names used both as a span and as a counter: {both}")
            out = {}
            for k in self.totals:
                entry = {
                    "total_s": self.totals[k],
                    "count": self.counts[k],
                    "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1),
                }
                ring = self._recent[k]
                if ring:
                    srt = sorted(ring)
                    entry["p50_ms"] = 1e3 * srt[len(srt) // 2]
                    entry["p99_ms"] = 1e3 * srt[min(len(srt) - 1, int(len(srt) * 0.99))]
                out[k] = entry
            for k in self._counters:
                out[k] = {"total": self._counters[k], "count": self._counter_events[k]}
            return out

    def reset(self):
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self._recent.clear()
            self._counters.clear()
            self._counter_events.clear()


SPANS = _Registry()


@contextlib.contextmanager
def trace(name: str):
    """Wall-time span in `SPANS`, and a range of the same name while a
    torch.profiler capture runs (outside one, a record_function would only
    add host time to every span)."""
    t0 = time.perf_counter()
    try:
        if torch.autograd._profiler_enabled():
            with record_function(name):
                yield
        else:
            yield
    finally:
        SPANS.add(name, time.perf_counter() - t0)


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Capture the block with `torch.profiler` (CPU, and CUDA where there is
    a card) into ``<log_dir>/trace.json``, a chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """steps/sec + images/sec counters with an exponential moving average."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self._last: float | None = None
        self.step_time_ema: float | None = None
        self.total_steps = 0
        self.total_images = 0
        self._t0 = time.perf_counter()

    def tick(self, batch_size: int) -> dict[str, float]:
        now = time.perf_counter()
        self.total_steps += 1
        self.total_images += batch_size
        out: dict[str, float] = {}
        if self._last is not None:
            dt = now - self._last
            self.step_time_ema = (
                dt if self.step_time_ema is None
                else self.ema * self.step_time_ema + (1 - self.ema) * dt
            )
            out["step_ms"] = dt * 1e3
            out["steps_per_sec"] = 1.0 / self.step_time_ema
            out["images_per_sec"] = batch_size / self.step_time_ema
        self._last = now
        out["avg_images_per_sec"] = self.total_images / max(now - self._t0, 1e-9)
        return out
