"""Roofline shares read only where the program ran what the work counts
count: the program's launch counter of the kernel
(`kernel/launches.<kernel>` in its span registry, one a call of the
kernel's wrapper) moved over the window by exactly the architecture's
launches of that kernel a forward times the window's forwards. Else the
share is None: a roofline never divides a count that the program did not
run."""

from __future__ import annotations

from . import readers


def roofline_pct(r, reader_file: str) -> float | None:
    kernel = readers.patterns(reader_file)["launches_of"]
    forwards = getattr(r, "forwards", 0)
    counted = readers.span_delta(r, f"kernel/launches.{kernel}", "total")
    per_forward = sum(1 for launch in r.arch.work.launches(r.cfg, r.batch) if launch["kernel"] == kernel)
    if not forwards or counted is None or counted != per_forward * forwards:
        return None
    return readers.roofline_pct(r, reader_file)
