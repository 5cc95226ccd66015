"""The traced window: torch.profiler over the measured window, reduced to
what the per-layer metrics and the breakdown read.

`Capture` profiles CPU and CUDA activity and marks the window with a
`bench/window` range; `Trace` keeps the device operations (kernels,
copies, sets) and the host events inside that range, in nanoseconds on the
profiler's clock. From them: the device's busy time (the union of its
operations' intervals), each kernel family's time by name, the device
operations that took most time, and the idle gaps labelled by the host
event running across them.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import numpy as np
import torch

WINDOW = "bench/window"
LABELLED_GAPS = 500  # the longest gaps get a host label each; the rest are summed as one entry


def _ns(e, what: str) -> int:
    if hasattr(e, f"{what}_ns"):
        return int(getattr(e, f"{what}_ns")())
    return int(getattr(e, f"{what}_us")() * 1000)


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its template arguments and parameter list."""
    out, depth = [], 0
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    s = "".join(out).replace("void ", "").strip() or name
    return s[:limit]


class Capture:
    """A context manager: torch.profiler over the block, its whole length
    marked as the window's range, when `on`; else nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.trace: Trace | None = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        if not self.on:
            return self
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = self._stack.enter_context(profile(activities=acts))
        self._stack.enter_context(record_function(WINDOW))
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        self._stack.close()
        if exc[0] is None:
            self.trace = Trace.from_events(self._prof.profiler.kineto_results.events())
        return False


class Trace:
    def __init__(self, window: tuple[int, int], device: list, host: list):
        self.window = window
        self.device = device  # (name, start_ns, end_ns), clipped to the window
        self.host = host  # (name, start_ns, end_ns, is_annotation)

    @classmethod
    def from_events(cls, events) -> "Trace":
        cuda = torch.autograd.DeviceType.CUDA
        rows, window = [], None
        for e in events:
            name = e.name()
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            on_device = e.device_type() == cuda
            if name == WINDOW and not on_device and window is None:
                window = (start, end)
                continue
            annotation = bool(getattr(e, "is_user_annotation", lambda: False)())
            rows.append((name, start, end, on_device, annotation))
        if window is None:
            raise RuntimeError(f"the profile has no {WINDOW} range")
        lo, hi = window
        # A host range is mirrored on the device's timeline as an annotation
        # of the same name: it is no operation of the device.
        ranges = {name for name, _, _, on_device, annotation in rows
                  if not on_device and (annotation or "/" in name)}
        ranges.add(WINDOW)
        device, host = [], []
        for name, start, end, on_device, annotation in rows:
            if end <= lo or start >= hi:
                continue
            if on_device:
                if annotation or name in ranges:
                    continue
                device.append((name, max(start, lo), min(end, hi)))
            else:
                host.append((name, start, end, annotation))
        return cls(window, device, host)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def _union(self) -> list[tuple[int, int]]:
        spans = sorted((s, e) for _, s, e in self.device)
        merged: list[list[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in self._union()) / 1e9

    def kernel_s(self, patterns: list[str]) -> float:
        """Summed seconds of the device operations whose name holds any of
        `patterns`; None of them ran gives 0."""
        return sum(e - s for n, s, e in self.device if any(p in n for p in patterns)) / 1e9

    def top_device_ops(self, n: int = 10) -> list:
        by = defaultdict(int)
        for name, s, e in self.device:
            by[short_name(name)] += e - s
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time by what the host was doing: each of the longest
        gaps between device operations is labelled by the innermost host
        event (a program span where there is one) across its middle; the
        shorter gaps are summed under one entry."""
        lo, hi = self.window
        bounds = [lo]
        for s, e in self._union():
            bounds += [s, e]
        bounds.append(hi)
        gaps = [(bounds[i], bounds[i + 1]) for i in range(0, len(bounds), 2) if bounds[i + 1] > bounds[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        labelled, rest = gaps[:LABELLED_GAPS], gaps[LABELLED_GAPS:]
        if self.host:
            starts = np.array([h[1] for h in self.host], np.int64)
            ends = np.array([h[2] for h in self.host], np.int64)
            annot = np.array([h[3] or "/" in h[0] for h in self.host])
        by = defaultdict(int)
        for s, e in labelled:
            label = "no traced host event"
            if self.host:
                mid = (s + e) // 2
                across = (starts <= mid) & (ends >= mid)
                pick = np.flatnonzero(across & annot)
                if pick.size == 0:
                    pick = np.flatnonzero(across)
                if pick.size:
                    label = "host: " + self.host[int(pick[np.argmax(starts[pick])])][0]
            by[label] += e - s
        if rest:
            by[f"{len(rest)} shorter gaps"] += sum(e - s for s, e in rest)
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def breakdown(self) -> dict:
        return {"device_ops": self.top_device_ops(), "idle_gaps": self.idle_gaps()}
