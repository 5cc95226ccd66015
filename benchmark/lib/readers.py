"""Shared arithmetic of the per-layer readers (benchmark/metrics/*.py).

A reader takes its cell driver's readings (a namespace: `cfg`, `arch` (the
cell's architecture: `arch.work` holds its work counts), `window_s`, `spans`
as the program's span registry before and after the window, `trace`, and
the counts its driver has) and returns its metric, or None
where there is nothing to read. A share of a roofline or of a peak is never
0: with no time measured there is no share.
"""

from __future__ import annotations

import json
import pathlib


def patterns(reader_file: str) -> dict:
    """The JSON beside a reader: its kernel-name patterns and the kernel
    whose launches they time."""
    return json.loads(pathlib.Path(reader_file).with_suffix(".json").read_text())


def span_delta(r, name: str, field: str) -> float | None:
    before, after = r.spans
    if name not in after:
        return None
    return after[name].get(field, 0.0) - before.get(name, {}).get(field, 0.0)


def roofline_pct(r, reader_file: str) -> float | None:
    """100 x (the bound of the window's launches of the kernel) / (their
    device time by kernel name in the trace)."""
    p = patterns(reader_file)
    if r.trace is None or not getattr(r, "forwards", 0):
        return None
    spent = r.trace.kernel_s(p["kernels"])
    if spent <= 0:
        return None
    return 100.0 * r.arch.work.bound_s(r.cfg, r.batch, p["launches_of"]) * r.forwards / spent


def idle_pct(r) -> float | None:
    if r.trace is None or r.trace.window_s <= 0 or not r.trace.device:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
