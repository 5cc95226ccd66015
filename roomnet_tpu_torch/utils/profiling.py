"""Tracing and profiling (port of roomnet_tpu/utils/profiling.py).

  * `trace(name)`: a context manager that marks the span for the PyTorch
    profiler (`torch.profiler.record_function`, visible in a chrome trace)
    and adds its wall time to the process-wide registry `SPANS`;
  * `SPANS.count(name, value)`: accumulates a value (bytes shipped, ...);
  * `trace_to(log_dir)`: a `torch.profiler` capture, written as a chrome trace;
  * `start_server(port)`: on-demand captures of a live process over HTTP
    (the counterpart of the JAX package's jax.profiler gRPC server).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
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


# Set while a capture of every thread runs (`trace_to(all_threads=True)`):
# the profiler's own flag is set only in the thread that started it.
_ALL_THREADS = threading.Event()


@contextlib.contextmanager
def trace(name: str):
    """Wall-time span in `SPANS`, and a range of the same name while a
    torch.profiler capture runs (outside one, a record_function would only
    add host time to every span)."""
    t0 = time.perf_counter()
    try:
        if _ALL_THREADS.is_set() or torch.autograd._profiler_enabled():
            with record_function(name):
                yield
        else:
            yield
    finally:
        SPANS.add(name, time.perf_counter() - t0)


@contextlib.contextmanager
def trace_to(log_dir: str, *, all_threads: bool = False):
    """Capture the block with `torch.profiler` (CPU, and CUDA where there is
    a card) into ``<log_dir>/trace.json``, a chrome trace. all_threads: the
    host ops and `trace` spans of every thread of the process, not only of
    the calling one (device activity is always the whole process's)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    kw = {}
    if all_threads:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, **kw) as prof:
        if all_threads:
            _ALL_THREADS.set()
        try:
            yield log_dir
        finally:
            _ALL_THREADS.clear()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


CAPTURE_MAX_S = 60.0


def start_server(port: int = 9999, log_dir: str | None = None):
    """On-demand trace capture of a live process (the counterpart of
    `jax.profiler.start_server`): a daemon thread serving HTTP on `port`.
    ``GET /capture?seconds=S`` (default 2, at most CAPTURE_MAX_S) records
    every thread of the process with `trace_to(..., all_threads=True)` for
    S seconds into a new directory under `log_dir` (fixed here, never
    taken from the request; default a directory under the temp dir) and
    answers ``{"trace": path to trace.json}``; a capture asked for while
    another runs answers 409. It listens on 127.0.0.1 only. Returns the
    HTTP server (`server_address[1]` is its port; `shutdown()` ends it)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), f"roomnet_profile_{os.getpid()}")
    busy = threading.Lock()
    taken = [0]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path != "/capture":
                self._send(404, {"error": "not found; GET /capture?seconds=S"})
                return
            try:
                seconds = float(parse_qs(url.query).get("seconds", ["2"])[0])
            except ValueError:
                self._send(400, {"error": "seconds must be a number"})
                return
            if not 0 < seconds <= CAPTURE_MAX_S:
                self._send(400, {"error": f"seconds must be in (0, {CAPTURE_MAX_S}]"})
                return
            if not busy.acquire(blocking=False):
                self._send(409, {"error": "a capture is running"})
                return
            try:
                taken[0] += 1
                out = os.path.join(log_dir, f"capture_{taken[0]:04d}")
                with trace_to(out, all_threads=True):
                    time.sleep(seconds)
            finally:
                busy.release()
            self._send(200, {"trace": os.path.join(out, "trace.json"), "seconds": seconds})

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True, name="roomnet-profile-server").start()
    return server

